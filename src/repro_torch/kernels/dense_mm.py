"""Tiled dense matmul: C = A @ B, the paper's conventional-MM baseline.

The port of ``repro.kernels.dense_mm``. ``dense_mm`` reaches the CUDA
kernels written by hand for Hopper in ``csrc/dense_mm.cu`` on the GEMM core
of ``csrc/gemm_sm90.cuh``: A and B are promoted to one type as JAX and the
plain version promote them; f32 runs IEEE f32 FMA (no TF32), bf16 runs
wgmma on the tensor cores, both with f32 sums, and a shape the fast
instances do not take runs the general kernel of its type
(``gemm_geometry``). The Pallas kernel needs every dimension a multiple of
its tiles and its caller pads; these kernels mask the ragged edges
themselves, so any (M, K) x (K, N) runs as it is. C has ``a.dtype``.

A tensor on the CPU takes the plain torch version; a CUDA tensor launches
a kernel or raises. ``LAUNCHES`` counts the launches, ``INSTANCE_LAUNCHES``
each instance's.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import _alloc, _build
from . import _gemm
from ._gemm import GemmGeometry
from .ref import dense_mm as _plain_dense

INSTANCES = _gemm.INSTANCES

LAUNCHES: Dict[str, int] = {"dense_mm": 0}
INSTANCE_LAUNCHES: Dict[str, int] = {name: 0 for name in INSTANCES}


def reset_launches() -> None:
    LAUNCHES["dense_mm"] = 0
    for name in INSTANCES:
        INSTANCE_LAUNCHES[name] = 0


def gemm_geometry(m: int, n: int, k: int, dtype: torch.dtype, *,
                  aligned: bool = True, splits: Optional[int] = None,
                  stages: Optional[int] = None,
                  tile_n: Optional[int] = None) -> GemmGeometry:
    """The launch of C[M, N] = A[M, K] @ B[K, N] in ``dtype`` (f32 or
    bf16): the fast instance of the type where K and N are multiples of 16
    bytes and both operands start on 16 bytes, else the general one.
    ``splits``, ``stages`` and ``tile_n`` override the rule (sweeps)."""
    if dtype not in _gemm.FAST:
        raise TypeError(f"dense_mm: no instance for {dtype}")
    vec = _gemm.VECTOR[dtype]
    if aligned and k % vec == 0 and n % vec == 0:
        instance = _gemm.FAST[dtype]
        return _gemm.fast_geometry(
            instance, -(-m // _gemm.TILE_M), n,
            -(-k // _gemm.TILE_K[instance]), splits=splits, stages=stages,
            tile_n=tile_n)
    row_tiles = -(-m // _gemm.TILE_M)
    if row_tiles > _gemm.GRID_Y_MAX:
        raise ValueError(f"dense_mm: M = {m} needs more row tiles than the "
                         f"grid allows")
    return GemmGeometry(_gemm.GENERAL[dtype], _gemm.TILE_M, _gemm.TILE_N, 8,
                        1, 0, 256, 0, row_tiles, -(-n // _gemm.TILE_N))


def _library() -> ctypes.CDLL:
    lib = _build.library("dense_mm")
    if not getattr(lib, "_repro_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dense_mm.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p, p, i,
                                 p]
        lib.dense_mm.restype = i
        lib.dense_mm_ctas_per_sm.argtypes = [i, i, i, i, p]
        lib.dense_mm_ctas_per_sm.restype = i
        lib.dense_mm_error_string.argtypes = [i]
        lib.dense_mm_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def ctas_per_sm(geo: GemmGeometry) -> int:
    """The CTAs of ``geo``'s instance that one SM of the current card
    holds, from the card's occupancy calculator."""
    lib = _library()
    out = ctypes.c_int(0)
    err = lib.dense_mm_ctas_per_sm(INSTANCES.index(geo.instance), geo.tile_n,
                                   geo.splits, geo.smem, ctypes.byref(out))
    if err:
        raise RuntimeError(f"dense_mm_ctas_per_sm: CUDA error {err}: "
                           f"{lib.dense_mm_error_string(err).decode()}")
    return out.value


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"dense_mm: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not contract")
    if a.device != b.device:
        raise ValueError(f"dense_mm: A and B must share one device, got "
                         f"{a.device} and {b.device}")


def _launch(a: torch.Tensor, b: torch.Tensor, geometry=None) -> torch.Tensor:
    """Validate, promote, allocate C, launch on the current stream and
    count the launch. Raises on anything the kernels do not take.
    ``geometry`` overrides ``gemm_geometry`` (for sweeps)."""
    dt = _gemm.compute_dtype(a.dtype, b.dtype, "dense_mm")
    for t, what in ((a, "A"), (b, "B")):
        if not t.is_contiguous():
            raise ValueError(f"dense_mm: {what} must be contiguous")
    out_dtype = a.dtype
    a, b = a.to(dt), b.to(dt)
    m, k = a.shape
    n = b.shape[1]
    out = _alloc.empty((m, n), dt, a.device)
    if out.numel() == 0 or k == 0:
        return out.zero_().to(out_dtype)
    geo = geometry or gemm_geometry(m, n, k, dt,
                                    aligned=_gemm.aligned(a, b, out))
    ws, tickets = _gemm.workspace(geo, a.device)
    lib = _library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.dense_mm(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                       INSTANCES.index(geo.instance), geo.tile_n, geo.splits,
                       geo.stages, geo.smem,
                       ws.data_ptr() if ws is not None else None,
                       tickets.data_ptr() if tickets is not None else None,
                       a.device.index, stream)
    if err:
        raise RuntimeError(f"dense_mm: CUDA error {err} at launch: "
                           f"{lib.dense_mm_error_string(err).decode()}")
    LAUNCHES["dense_mm"] += 1
    INSTANCE_LAUNCHES[geo.instance] += 1
    return out if out_dtype == dt else out.to(out_dtype)


def plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain torch version on any device, with the wrapper's checks:
    what the kernels are held against."""
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
