"""Causal grouped-query flash attention.

The port of ``repro.kernels.flash_attention``. ``flash_attention`` reaches
the CUDA kernels written by hand for Hopper in ``csrc/flash_attention.cu``:
one CTA per (query lane, query tile) walks the 64-key tiles from the first
one its window reaches to the diagonal with an online softmax in f32,
wholly masked key tiles skipped, the heaviest query tiles first.

It takes the JAX ``ops.flash_mha`` layout as it is, q (B, Sq, KV, G, hd)
and k/v (B, Sk, KV, hd), and reads it through strides: the Pallas wrapper's
lane transposes and its padding of Sq and Sk to the tiles are gone, since
the kernels mask their ragged tiles. Query head (kv, g) reads KV head kv
(the Pallas kernel's ``lane // g``). The output has q's layout and dtype.
``q_offset`` places query row r at position r + q_offset (keys stay at
0..Sk-1): a span of a longer sequence, as sequence-parallel attention over
a mesh hands each coordinate (``models.layers.attention_sharded``).

The kernel is chosen by the type of q, k and v (one type for all three):

* bf16 runs ``flash_kernel_bf16``: both products on the tensor cores
  (``wgmma``, f32 accumulation), K and V fed by TMA through a two-stage
  ring. TMA reads the operands through tensor maps, so every stride but
  the head dim's must be a positive multiple of 8 elements (16 bytes) and
  q, k and v must be 16-byte aligned; anything else raises.
* f32 runs ``flash_kernel_f32``: f32 FMA outside the tensor cores, so the
  port's f32 results stay IEEE f32 (no TF32).

This is a routing rule, not a fallback: a bf16 call never reaches the f32
kernel, and a launch that fails raises. Any other type raises. Both take a
head dim that is a multiple of 8 up to 256. A tensor on the CPU takes the
plain torch version, ``ref.flash_attention``; a CUDA tensor launches a
kernel or raises. ``LAUNCHES`` counts the launches, ``ROUTE_LAUNCHES`` them
by kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from . import _alloc, _build
from .ref import flash_attention as _plain_flash

# Shared memory one block may use on an H100 (227 KB).
SMEM_LIMIT = 232_448
HD_MAX = 256
KEY_TILE = 64                   # both kernels walk 64-key tiles
# Query rows per CTA: one warpgroup per 64 rows in the bf16 kernel.
Q_TILE = {"f32_fma": 64, "bf16_wgmma": 128}
_INT_MAX = 2 ** 31 - 1          # the grid's x extent and the kernel's ints
_TMA_STRIDE_MAX = 2 ** 39       # elements: TMA strides stay under 2^40 bytes
ROUTES = {torch.float32: "f32_fma", torch.bfloat16: "bf16_wgmma"}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The kernels' symbols (what a profiler's trace names them by).
KERNEL_SYMBOLS = {"f32_fma": "flash_kernel_f32",
                  "bf16_wgmma": "flash_kernel_bf16"}

LAUNCHES: Dict[str, int] = {"flash_attention": 0}
ROUTE_LAUNCHES: Dict[str, int] = {r: 0 for r in ROUTES.values()}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0
    for r in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[r] = 0


def _library() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    if not getattr(lib, "_repro_bound", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention.argtypes = [
            p, p, p, p, ctypes.POINTER(ctypes.c_longlong),
            i, i, i, i, i, i, i, i, i, f, f, i, i, ctypes.c_size_t, i, p]
        lib.flash_attention.restype = i
        lib.flash_attention_ctas_per_sm.argtypes = [i, i, ctypes.c_size_t,
                                                    p]
        lib.flash_attention_ctas_per_sm.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def ctas_per_sm(launch: "Launch", hd: int) -> int:
    """The CTAs of ``launch``'s kernel at head dim ``hd`` that one SM of
    the current card holds, from the card's occupancy calculator."""
    lib = _library()
    out = ctypes.c_int(0)
    err = lib.flash_attention_ctas_per_sm(
        list(ROUTES.values()).index(launch.route), hd, launch.smem,
        ctypes.byref(out))
    if err:
        raise RuntimeError(f"flash_attention_ctas_per_sm: error {err}: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    return out.value


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


# ----------------------------------------------------------------------
# The launch geometry, computed here only: the C launcher takes the query
# tiles and the shared memory as given.
def smem_bytes(hd: int, route: str) -> int:
    """Shared memory per block of the kernel ``route`` at head dim hd."""
    if route == "bf16_wgmma":
        hdp = -(-hd // 64) * 64
        # Q of two warpgroups and a K/V ring of two stages, each tile
        # HDP/64 swizzled 8 KB regions; 1,024 bytes to align them; three
        # mbarriers.
        return 6 * hdp * 128 + 1024 + 8 * 3
    nj = -(-hd // 64)
    return ((hd + max(hd, KEY_TILE)) * 68 + KEY_TILE * nj * 64) * 4


@dataclasses.dataclass(frozen=True)
class Launch:
    """What ``flash_attention`` hands the C interface for one call."""
    route: str
    smem: int
    n_qt: int                    # query tiles of Q_TILE[route] rows; the
                                 # grid is B * KV * G lanes x n_qt
    strides: Tuple[int, ...]     # q (b, s, kv, g), k, v (b, s, kv)


def _tma_strides(t: torch.Tensor, what: str) -> Tuple[int, ...]:
    """t's strides over (b, s, kv[, g]) as TMA takes them: a dim of one
    element gets the head dim's row length (any legal stride reads the
    same); every other must be a positive multiple of 8 elements."""
    hd = t.shape[-1]
    out = []
    for size, st in zip(t.shape[:-1], t.stride()[:-1]):
        if size == 1:
            st = hd
        elif st <= 0 or st % 8 or st >= _TMA_STRIDE_MAX:
            raise ValueError(f"flash_attention: the bf16 kernel reads {what} "
                             f"by TMA, which needs every stride but the head "
                             f"dim's a positive multiple of 8 elements; "
                             f"{what} has strides {tuple(t.stride())}")
        out.append(st)
    return tuple(out)


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         window: Optional[int] = None, q_offset: int = 0) -> Launch:
    """Check what the kernels take and choose the route by type; raises on
    anything no kernel takes. Reads only shapes, types, strides and
    addresses, so it runs on tensors of any device."""
    _check(q, k, v)
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: the kernels take f32 or bf16 q, k "
                        f"and v of one type, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    route = ROUTES[q.dtype]
    b, sq, kv, g, hd = q.shape
    sk = k.shape[1]
    if hd % 8 or hd > HD_MAX:
        raise ValueError(f"flash_attention: the kernels take a head dim that "
                         f"is a multiple of 8 up to {HD_MAX}, got {hd}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {what} must be contiguous in "
                             f"its head dim")
    if window is not None and not -_INT_MAX <= int(window) <= _INT_MAX:
        raise ValueError(f"flash_attention: window {window} does not fit "
                         f"in 32 bits")
    if not 0 <= int(q_offset) <= _INT_MAX - sq:
        raise ValueError(f"flash_attention: q_offset {q_offset} must be >= 0 "
                         f"and keep the last position in 32 bits")
    lanes, n_qt = b * kv * g, -(-sq // Q_TILE[route])
    if lanes * n_qt > _INT_MAX or max(sq, sk) > _INT_MAX:
        raise ValueError(f"flash_attention: {lanes} lanes x {n_qt} query "
                         f"tiles do not fit the grid")
    if route == "bf16_wgmma":
        strides = _tma_strides(q, "q") + _tma_strides(k, "k") + \
            _tma_strides(v, "v")
        for t, what in ((q, "q"), (k, "k"), (v, "v")):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention: the bf16 kernel reads "
                                 f"{what} by TMA, which needs it 16-byte "
                                 f"aligned")
    else:
        strides = (*q.stride()[:4], *k.stride()[:3], *v.stride()[:3])
    smem = smem_bytes(hd, route)
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_attention: needs {smem} bytes of shared "
                         f"memory per block, over the card's {SMEM_LIMIT}")
    return Launch(route, smem, n_qt, strides)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            window: Optional[int], soft_cap, q_offset: int = 0
            ) -> torch.Tensor:
    """Plan, allocate the output, launch on the current stream and count
    the launch. Raises on anything the kernels do not take."""
    launch = plan(q, k, v, window, q_offset)
    b, sq, kv, g, hd = q.shape
    out = _alloc.empty(q.shape, q.dtype, q.device)
    if out.numel() == 0:
        return out
    lib = _library()
    strides = (ctypes.c_longlong * 14)(*launch.strides, *out.stride()[:4])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        b, kv, g, sq, k.shape[1], hd, int(q_offset), int(window is not None),
        0 if window is None else int(window), 1.0 / math.sqrt(hd),
        float(soft_cap) if soft_cap else 0.0, _DTYPE_CODE[q.dtype],
        launch.n_qt, launch.smem, q.device.index, stream)
    if err:
        raise RuntimeError(f"flash_attention: error {err} at launch: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    LAUNCHES["flash_attention"] += 1
    ROUTE_LAUNCHES[launch.route] += 1
    return out


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          window: Optional[int] = None, soft_cap=None,
          chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """The plain torch version on any device, with the wrapper's checks:
    what the kernel is held against."""
    _check(q, k, v)
    if int(q_offset) < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} must be >= 0")
    return _plain_flash(q, k, v, window=window, soft_cap=soft_cap,
                        chunk=chunk, q_offset=int(q_offset))


def worst_row_error(out: torch.Tensor, want: torch.Tensor) -> float:
    """max over query rows of max|out - want| / max|want|, a row being one
    query head's head-dim vector at one position; a row of zeros in
    ``want`` must be matched exactly (inf otherwise). What the bf16 kernel
    is held against: the whole output's max|want| comes from the first
    rows, which average a few keys, so a bound on it lets through an error
    confined to the long rows, whose outputs are far smaller."""
    err = (out.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    ratio = torch.where(scale > 0, err / scale.clamp_min(1e-30),
                        torch.where(err > 0, math.inf, 0.0))
    return float(ratio.max()) if ratio.numel() else 0.0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None, soft_cap=None,
                    chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """Causal GQA attention, q (B, Sq, KV, G, hd), k/v (B, Sk, KV, hd) ->
    (B, Sq, KV, G, hd) in ``q.dtype``; query row r at position r +
    ``q_offset``. ``chunk`` is the plain version's key chunk (CPU tensors
    only); the kernels' tiles are fixed.

    The kernels have no backward, so with grad mode on, inputs that
    require grad raise on every device rather than get an output cut off
    from autograd (ROADMAP queue 3, P5): train through
    ``models.layers._flash_attention``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError(
            "flash_attention: q, k or v requires grad, and the flash "
            "kernels have no backward, so the output would be cut off from "
            "autograd (ROADMAP queue 3, P5); train through "
            "models.layers._flash_attention, or call under torch.no_grad()")
    if q.device.type == "cpu":
        return plain(q, k, v, window=window, soft_cap=soft_cap, chunk=chunk,
                     q_offset=q_offset)
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _launch(q, k, v, window, soft_cap, q_offset)
