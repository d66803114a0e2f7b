"""Block-sparse x dense SpMM steered by prefix counters: C = BSR(A) @ B.

The port of ``repro.kernels.bsr_spmm``. ``bsr_spmm`` takes the kernel block
lists of ``ops.prep_bsr`` (``row_of`` sorted with its trailing sentinel,
``col_of``, the stored ``values``) and reaches the CUDA kernel written by
hand for Hopper in ``csrc/bsr_spmm.cu``: one CTA per (block-row, column
tile) walks that row's run of stored blocks. The runs start at
``row_start``, the prefix counters of the block-rows, which prep derives
once (``block_row_starts``): a launch derives nothing.

The Pallas kernel needs N to be a multiple of its column tile and its
caller pads B; this kernel masks the ragged column tile itself, so there
is no ``bn``. C has shape (n_block_rows * bm, N) and ``b.dtype``; the sums
are f32. On the card the kernel takes f32 only.

A tensor on the CPU takes the plain torch version (a gather, one batched
product and an ``index_add``); a CUDA tensor launches the kernel or
raises. ``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from . import _build
from .ref import bsr_spmm as _plain_bsr

# Shared memory one block may use on an H100 (227 KB).
SMEM_LIMIT = 232_448
_GRID_Y_MAX = 65_535

LAUNCHES: Dict[str, int] = {"bsr_spmm": 0}


def reset_launches() -> None:
    LAUNCHES["bsr_spmm"] = 0


def block_row_starts(row_of, n_block_rows: int) -> np.ndarray:
    """int32 (n_block_rows + 1,) start of each block-row's run in the
    sorted block list: the block-row prefix counters. ``row_of`` is given
    WITHOUT its trailing sentinel (``row_of[:nnz]``)."""
    row_of = np.asarray(row_of, np.int64)
    return np.searchsorted(row_of, np.arange(n_block_rows + 1),
                           side="left").astype(np.int32)


def _library() -> ctypes.CDLL:
    lib = _build.library("bsr_spmm")
    if not getattr(lib, "_repro_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bsr_spmm.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.bsr_spmm.restype = i
        lib.bsr_spmm_smem_bytes.argtypes = [i]
        lib.bsr_spmm_smem_bytes.restype = ctypes.c_size_t
        lib.bsr_spmm_error_string.argtypes = [i]
        lib.bsr_spmm_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


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
            row_start: torch.Tensor, n_block_rows: int) -> torch.Tensor:
    """Validate, allocate C, launch on the current stream and count the
    launch. Raises on anything the kernel does not take."""
    if values.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"bsr_spmm: the kernel takes f32 values and B, got "
                        f"{values.dtype} and {b.dtype}; bf16 is a later "
                        f"mode (ROADMAP)")
    if col_of.dtype != torch.int32 or row_start.dtype != torch.int32:
        raise TypeError(f"bsr_spmm: col_of and row_start must be int32, got "
                        f"{col_of.dtype} and {row_start.dtype}")
    for t, what in ((col_of, "col_of"), (values, "values"), (b, "B"),
                    (row_start, "row_start")):
        if not t.is_contiguous():
            raise ValueError(f"bsr_spmm: {what} must be contiguous")
    _, bm, bk = values.shape
    n = b.shape[1]
    out = torch.empty((n_block_rows * bm, n), dtype=torch.float32,
                      device=b.device)
    if out.numel() == 0:
        return out
    lib = _library()
    smem = lib.bsr_spmm_smem_bytes(bm)
    if smem > SMEM_LIMIT:
        raise ValueError(f"bsr_spmm: needs {smem} bytes of shared memory "
                         f"per block, over the card's {SMEM_LIMIT}")
    if n > _GRID_Y_MAX * 64:
        raise ValueError(f"bsr_spmm: N = {n} needs more column tiles than "
                         f"the grid allows")
    stream = torch.cuda.current_stream(b.device).cuda_stream
    err = lib.bsr_spmm(row_start.data_ptr(), col_of.data_ptr(),
                       values.data_ptr(), b.data_ptr(), out.data_ptr(),
                       n_block_rows, bm, bk, n, b.device.index, stream)
    if err:
        raise RuntimeError(f"bsr_spmm: CUDA error {err} at launch: "
                           f"{lib.bsr_spmm_error_string(err).decode()}")
    LAUNCHES["bsr_spmm"] += 1
    return out


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
