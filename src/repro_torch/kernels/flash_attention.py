"""Causal grouped-query flash attention.

The port of ``repro.kernels.flash_attention``. ``flash_attention`` reaches
the CUDA kernel written by hand for Hopper in ``csrc/flash_attention.cu``:
one CTA per (query lane, 64-query tile) walks the 64-key tiles from the
first one its window reaches to the diagonal with an online softmax in f32,
K and V staged in shared memory, wholly masked key tiles skipped.

It takes the JAX ``ops.flash_mha`` layout as it is, q (B, Sq, KV, G, hd)
and k/v (B, Sk, KV, hd), and reads it through strides: the Pallas wrapper's
lane transposes and its padding of Sq and Sk to the tiles are gone, since
the kernel masks its ragged tiles. Query head (kv, g) reads KV head kv (the
Pallas kernel's ``lane // g``). The output has q's layout and dtype.

On the card the kernel takes f32 or bf16 (q, k and v of one type) and a
head dim that is a multiple of 8 up to 256; anything else raises. A tensor
on the CPU takes the plain torch version, ``ref.flash_attention``; a CUDA
tensor launches the kernel or raises. ``LAUNCHES`` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from . import _build
from .ref import flash_attention as _plain_flash

# Shared memory one block may use on an H100 (227 KB).
SMEM_LIMIT = 232_448
HD_MAX = 256
_TILE = 64
_INT_MAX = 2 ** 31 - 1          # the grid's x extent and the kernel's ints
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {"flash_attention": 0}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def _library() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    if not getattr(lib, "_repro_bound", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention.argtypes = [
            p, p, p, p, ctypes.POINTER(ctypes.c_longlong),
            i, i, i, i, i, i, i, i, f, f, i, i, p]
        lib.flash_attention.restype = i
        lib.flash_attention_smem_bytes.argtypes = [i]
        lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 5 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q must be (B, Sq, KV, G, hd) and "
                         f"k, v (B, Sk, KV, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, kv, _, hd = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, kv, hd):
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} in B, KV or hd")
    for t in (q, k, v):
        if not t.dtype.is_floating_point:
            raise TypeError(f"flash_attention: q, k and v must be floating "
                            f"point, got {q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"flash_attention: q, k and v must share one "
                         f"device, got {q.device}, {k.device}, {v.device}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            window: Optional[int], soft_cap) -> torch.Tensor:
    """Validate, allocate the output, launch on the current stream and
    count the launch. Raises on anything the kernel does not take."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: the kernel takes f32 or bf16 q, k "
                        f"and v of one type, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, sq, kv, g, hd = q.shape
    sk = k.shape[1]
    if hd % 8 or hd > HD_MAX:
        raise ValueError(f"flash_attention: the kernel takes a head dim that "
                         f"is a multiple of 8 up to {HD_MAX}, got {hd}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {what} must be contiguous in "
                             f"its head dim")
    if window is not None and not -_INT_MAX <= int(window) <= _INT_MAX:
        raise ValueError(f"flash_attention: window {window} does not fit "
                         f"in 32 bits")
    lanes, n_qt = b * kv * g, -(-sq // _TILE)
    if lanes * n_qt > _INT_MAX or max(sq, sk) > _INT_MAX:
        raise ValueError(f"flash_attention: {lanes} lanes x {n_qt} query "
                         f"tiles do not fit the grid")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _library()
    smem = lib.flash_attention_smem_bytes(hd)
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_attention: needs {smem} bytes of shared "
                         f"memory per block, over the card's {SMEM_LIMIT}")
    strides = (ctypes.c_longlong * 14)(
        *q.stride()[:4], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:4])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        b, kv, g, sq, sk, hd, int(window is not None),
        0 if window is None else int(window), 1.0 / math.sqrt(hd),
        float(soft_cap) if soft_cap else 0.0, _DTYPES[q.dtype],
        q.device.index, stream)
    if err:
        raise RuntimeError(f"flash_attention: CUDA error {err} at launch: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    LAUNCHES["flash_attention"] += 1
    return out


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          window: Optional[int] = None, soft_cap=None,
          chunk: int = 1024) -> torch.Tensor:
    """The plain torch version on any device, with the wrapper's checks:
    what the kernel is held against."""
    _check(q, k, v)
    return _plain_flash(q, k, v, window=window, soft_cap=soft_cap,
                        chunk=chunk)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None, soft_cap=None,
                    chunk: int = 1024) -> torch.Tensor:
    """Causal GQA attention, q (B, Sq, KV, G, hd), k/v (B, Sk, KV, hd) ->
    (B, Sq, KV, G, hd) in ``q.dtype``. ``chunk`` is the plain version's
    key chunk (CPU tensors only); the kernel's tiles are fixed."""
    if q.device.type == "cpu":
        return plain(q, k, v, window=window, soft_cap=soft_cap, chunk=chunk)
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _launch(q, k, v, window, soft_cap)
