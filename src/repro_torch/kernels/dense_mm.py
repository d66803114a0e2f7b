"""Tiled dense matmul: C = A @ B, the paper's conventional-MM baseline.

The port of ``repro.kernels.dense_mm``. ``dense_mm`` reaches the CUDA
kernel written by hand for Hopper in ``csrc/dense_mm.cu``: 128 x 128 output
tiles in shared memory, 8 x 8 register tiles of f32 FMA, no TF32. The
Pallas kernel needs every dimension a multiple of its tiles and its caller
pads; this kernel masks the ragged edges itself, so any (M, K) x (K, N)
runs as it is. C has ``a.dtype``; the sums are f32. On the card the kernel
takes f32 only.

A tensor on the CPU takes the plain torch version; a CUDA tensor launches
the kernel or raises. ``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build
from .ref import dense_mm as _plain_dense

_GRID_Y_MAX = 65_535
_TILE = 128

LAUNCHES: Dict[str, int] = {"dense_mm": 0}


def reset_launches() -> None:
    LAUNCHES["dense_mm"] = 0


def _library() -> ctypes.CDLL:
    lib = _build.library("dense_mm")
    if not getattr(lib, "_repro_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dense_mm.argtypes = [p, p, p, i, i, i, i, p]
        lib.dense_mm.restype = i
        lib.dense_mm_error_string.argtypes = [i]
        lib.dense_mm_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"dense_mm: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not contract")
    if a.device != b.device:
        raise ValueError(f"dense_mm: A and B must share one device, got "
                         f"{a.device} and {b.device}")


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Validate, allocate C, launch on the current stream and count the
    launch. Raises on anything the kernel does not take."""
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"dense_mm: the kernel takes f32 A and B, got "
                        f"{a.dtype} and {b.dtype}; bf16 is a later mode "
                        f"(ROADMAP)")
    for t, what in ((a, "A"), (b, "B")):
        if not t.is_contiguous():
            raise ValueError(f"dense_mm: {what} must be contiguous")
    m, k = a.shape
    n = b.shape[1]
    if -(-m // _TILE) > _GRID_Y_MAX:
        raise ValueError(f"dense_mm: M = {m} needs more row tiles than the "
                         f"grid allows")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    lib = _library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.dense_mm(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                       a.device.index, stream)
    if err:
        raise RuntimeError(f"dense_mm: CUDA error {err} at launch: "
                           f"{lib.dense_mm_error_string(err).decode()}")
    LAUNCHES["dense_mm"] += 1
    return out


def plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain torch version on any device, with the wrapper's checks:
    what the kernel is held against."""
    _check(a, b)
    return _plain_dense(a, b)


def dense_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[M, N] = A[M, K] @ B[K, N], f32 sums, C in ``a.dtype``."""
    if a.device.type == "cpu":
        return plain(a, b)
    _check(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"dense_mm: no kernel for device {a.device}")
    return _launch(a, b)
