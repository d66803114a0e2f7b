"""Block-sparse x dense SpMM steered by prefix counters: C = BSR(A) @ B.

The port of ``repro.kernels.bsr_spmm``. ``bsr_spmm`` takes the kernel block
lists of ``ops.prep_bsr`` (``row_of`` sorted with its trailing sentinel,
``col_of``, the stored ``values``) and reaches the CUDA kernels written by
hand for Hopper in ``csrc/bsr_spmm.cu``: one CTA per (block-row, rows,
column tile) walks that row's run of stored blocks. The runs start at
``row_start``, the prefix counters of the block-rows, which prep derives
once (``block_row_starts``): a launch derives nothing.

The values and B are promoted to one type as JAX and the plain version
promote them. Block shapes the GEMM core of ``csrc/gemm_sm90.cuh`` takes
(bm a multiple of 64, bk of 16 in f32 and of 64 in bf16) run its f32-FMA
or bf16-wgmma instance; any other shape runs the general kernel of its
type (``gemm_geometry``). The Pallas kernel needs N to be a multiple of its
column tile and its caller pads B; these kernels mask the ragged column
tile themselves, so there is no ``bn``. C has shape (n_block_rows * bm, N)
and ``b.dtype``; the sums are f32.

A tensor on the CPU takes the plain torch version (a gather, one batched
product and an ``index_add``); a CUDA tensor launches a kernel or raises.
``LAUNCHES`` counts the launches, ``INSTANCE_LAUNCHES`` each instance's.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build
from . import _gemm
from ._gemm import GemmGeometry
from .ref import bsr_spmm as _plain_bsr

INSTANCES = _gemm.INSTANCES
GENERAL_TM = (1, 2, 4, 8)      # the general kernel's instances

LAUNCHES: Dict[str, int] = {"bsr_spmm": 0}
INSTANCE_LAUNCHES: Dict[str, int] = {name: 0 for name in INSTANCES}


def reset_launches() -> None:
    LAUNCHES["bsr_spmm"] = 0
    for name in INSTANCES:
        INSTANCE_LAUNCHES[name] = 0


def block_row_starts(row_of, n_block_rows: int) -> np.ndarray:
    """int32 (n_block_rows + 1,) start of each block-row's run in the
    sorted block list: the block-row prefix counters. ``row_of`` is given
    WITHOUT its trailing sentinel (``row_of[:nnz]``)."""
    row_of = np.asarray(row_of, np.int64)
    return np.searchsorted(row_of, np.arange(n_block_rows + 1),
                           side="left").astype(np.int32)


def general_layout(bm: int) -> Tuple[int, int, int, int, int, int]:
    """The general kernel's layout for block rows ``bm``: (rows a thread
    ``tm``, row threads, column threads, rows allocated, column tile
    ``bn``, CTAs along one block's rows)."""
    rows = min(bm, 128)
    need = -(-rows // 16)          # rows a thread for <= 16 row threads
    tm = next(t for t in GENERAL_TM if need <= t or t == GENERAL_TM[-1])
    row_threads = -(-rows // tm)
    col_threads = min(256 // row_threads, 64)
    return (tm, row_threads, col_threads, row_threads * tm, col_threads * 4,
            -(-bm // 128))


def gemm_geometry(n_block_rows: int, bm: int, bk: int, n: int,
                  dtype: torch.dtype, *, nnz: int, aligned: bool = True,
                  splits: Optional[int] = None, stages: Optional[int] = None,
                  tile_n: Optional[int] = None) -> GemmGeometry:
    """The launch of C = BSR(A) @ B in ``dtype`` (f32 or bf16) for
    ``n_block_rows`` block-rows of (bm, bk) blocks, ``nnz`` stored, and N
    columns: the fast instance of the type where bm is a multiple of 64,
    bk of its K step and N of 16 bytes (operands on 16 bytes), else the
    general one. ``splits``, ``stages`` and ``tile_n`` override the rule
    (sweeps)."""
    if dtype not in _gemm.FAST:
        raise TypeError(f"bsr_spmm: no instance for {dtype}")
    instance = _gemm.FAST[dtype]
    tk = _gemm.TILE_K[instance]
    if aligned and bm % 64 == 0 and bk % tk == 0 and \
            n % _gemm.VECTOR[dtype] == 0:
        steps = nnz * (bk // tk) / max(n_block_rows, 1)   # mean per tile
        return _gemm.fast_geometry(
            instance, n_block_rows * -(-bm // _gemm.TILE_M), n, steps,
            splits=splits, stages=stages, tile_n=tile_n)
    layout = general_layout(bm)
    bn = layout[4]
    if -(-n // bn) > _gemm.GRID_Y_MAX:
        raise ValueError(f"bsr_spmm: N = {n} needs more column tiles of "
                         f"{bn} than the grid allows")
    row_tiles = n_block_rows * layout[5]
    if row_tiles > _gemm.GRID_X_MAX:
        raise ValueError(f"bsr_spmm: {row_tiles} row tiles exceed the grid")
    geo = GemmGeometry(_gemm.GENERAL[dtype], min(bm, 128), bn, 16, 1, 0,
                       256, 16 * (layout[3] + 1 + bn) * 4, row_tiles,
                       -(-n // bn), layout)
    _gemm.check_smem(geo)
    return geo


def _library() -> ctypes.CDLL:
    lib = _build.library("bsr_spmm")
    if not getattr(lib, "_repro_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bsr_spmm.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                                 i, i, p, p, p, i, p]
        lib.bsr_spmm.restype = i
        lib.bsr_spmm_ctas_per_sm.argtypes = [i, i, i, i, i, p]
        lib.bsr_spmm_ctas_per_sm.restype = i
        lib.bsr_spmm_error_string.argtypes = [i]
        lib.bsr_spmm_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def ctas_per_sm(geo: GemmGeometry) -> int:
    """The CTAs of ``geo``'s instance that one SM of the current card
    holds, from the card's occupancy calculator."""
    lib = _library()
    out = ctypes.c_int(0)
    err = lib.bsr_spmm_ctas_per_sm(
        INSTANCES.index(geo.instance), geo.tile_n, geo.splits, geo.smem,
        geo.layout[0] if geo.layout else 0, ctypes.byref(out))
    if err:
        raise RuntimeError(f"bsr_spmm_ctas_per_sm: CUDA error {err}: "
                           f"{lib.bsr_spmm_error_string(err).decode()}")
    return out.value


def _check(row_of: torch.Tensor, col_of: torch.Tensor, values: torch.Tensor,
           b: torch.Tensor, n_block_rows: int,
           row_start: Optional[torch.Tensor] = None) -> None:
    if values.ndim != 3 or b.ndim != 2:
        raise ValueError(f"bsr_spmm: values must be (nnz, bm, bk) and B "
                         f"2-D, got {tuple(values.shape)} and "
                         f"{tuple(b.shape)}")
    nnz, _, bk = values.shape
    if tuple(col_of.shape) != (nnz,) or tuple(row_of.shape) != (nnz + 1,):
        raise ValueError(f"bsr_spmm: {nnz} blocks need col_of ({nnz},) and "
                         f"row_of ({nnz + 1},) with its sentinel, got "
                         f"{tuple(col_of.shape)} and {tuple(row_of.shape)}")
    if b.shape[0] % bk:
        raise ValueError(f"bsr_spmm: B has {b.shape[0]} rows, not a "
                         f"multiple of the block side bk={bk}")
    if n_block_rows < 0:
        raise ValueError(f"bsr_spmm: n_block_rows={n_block_rows} < 0")
    if len({row_of.device, col_of.device, values.device, b.device}) != 1:
        raise ValueError(f"bsr_spmm: block lists, values and B must share "
                         f"one device, got {row_of.device}, {col_of.device},"
                         f" {values.device}, {b.device}")
    if row_start is not None and (
            tuple(row_start.shape) != (n_block_rows + 1,) or
            row_start.device != b.device):
        raise ValueError(f"bsr_spmm: row_start must be ({n_block_rows + 1},)"
                         f" on {b.device}, got {tuple(row_start.shape)} on "
                         f"{row_start.device}")


def _launch(col_of: torch.Tensor, values: torch.Tensor, b: torch.Tensor,
            row_start: torch.Tensor, n_block_rows: int,
            geometry: Optional[GemmGeometry] = None) -> torch.Tensor:
    """Validate, promote, allocate C, launch on the current stream and
    count the launch. Raises on anything the kernels do not take.
    ``geometry`` overrides ``gemm_geometry`` (for sweeps)."""
    dt = _gemm.compute_dtype(values.dtype, b.dtype, "bsr_spmm")
    if col_of.dtype != torch.int32 or row_start.dtype != torch.int32:
        raise TypeError(f"bsr_spmm: col_of and row_start must be int32, got "
                        f"{col_of.dtype} and {row_start.dtype}")
    for t, what in ((col_of, "col_of"), (values, "values"), (b, "B"),
                    (row_start, "row_start")):
        if not t.is_contiguous():
            raise ValueError(f"bsr_spmm: {what} must be contiguous")
    out_dtype = b.dtype
    values, b = values.to(dt), b.to(dt)
    nnz, bm, bk = values.shape
    k, n = b.shape
    out = torch.empty((n_block_rows * bm, n), dtype=dt, device=b.device)
    if out.numel() == 0 or k == 0:
        return out.zero_().to(out_dtype)
    geo = geometry or gemm_geometry(
        n_block_rows, bm, bk, n, dt, nnz=nnz,
        aligned=_gemm.aligned(values, b, out))
    ws, tickets = _gemm.workspace(geo, b.device)
    layout = (ctypes.c_int * 6)(*(geo.layout or (0,) * 6))
    lib = _library()
    stream = torch.cuda.current_stream(b.device).cuda_stream
    err = lib.bsr_spmm(row_start.data_ptr(), col_of.data_ptr(),
                       values.data_ptr(), b.data_ptr(), out.data_ptr(),
                       n_block_rows, bm, bk, k, n, nnz,
                       INSTANCES.index(geo.instance), geo.tile_n, geo.splits,
                       geo.stages, geo.smem, layout,
                       ws.data_ptr() if ws is not None else None,
                       tickets.data_ptr() if tickets is not None else None,
                       b.device.index, stream)
    if err:
        raise RuntimeError(f"bsr_spmm: CUDA error {err} at launch: "
                           f"{lib.bsr_spmm_error_string(err).decode()}")
    LAUNCHES["bsr_spmm"] += 1
    INSTANCE_LAUNCHES[geo.instance] += 1
    return out if out_dtype == dt else out.to(out_dtype)


def plain(row_of: torch.Tensor, col_of: torch.Tensor, values: torch.Tensor,
          b: torch.Tensor, *, n_block_rows: int) -> torch.Tensor:
    """The plain torch version on any device, with the wrapper's checks:
    what the kernel is held against."""
    _check(row_of, col_of, values, b, n_block_rows)
    return _plain_bsr(row_of, col_of, values, b, n_block_rows)


def bsr_spmm(row_of: torch.Tensor, col_of: torch.Tensor,
             values: torch.Tensor, b: torch.Tensor, *, n_block_rows: int,
             row_start: torch.Tensor) -> torch.Tensor:
    """C[n_block_rows * bm, N] = BSR(A) @ B.

    row_of    : (nnz + 1,) int32 block-row of each stored block, sorted,
                with one sentinel repeat at the end
    col_of    : (nnz,) int32 block-column of each stored block
    values    : (nnz, bm, bk) the dense stored tiles
    b         : (K, N) dense right operand, K a multiple of bk
    row_start : (n_block_rows + 1,) int32 run starts from prep
                (``block_row_starts``); the plain version needs none
    """
    _check(row_of, col_of, values, b, n_block_rows, row_start)
    if b.device.type == "cpu":
        return _plain_bsr(row_of, col_of, values, b, n_block_rows)
    if b.device.type != "cuda":
        raise ValueError(f"bsr_spmm: no kernel for device {b.device}")
    return _launch(col_of, values, b, row_start, n_block_rows)
