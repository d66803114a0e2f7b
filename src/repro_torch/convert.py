"""Carry an operand's state across from the JAX package.

The system has no weights; its state is the sparse operand. These take the
fields of a ``repro`` ``CRS``, ``InCRS``, ``PreparedOperand`` or per-round
prep as numpy arrays (``np.asarray`` of each) and build the port's objects
from them, so both packages can be fed the same operand.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .core.crs import CRS
from .core.incrs import InCRS
from .kernels.ops import PreparedOperand, resolve_device


def crs_from_arrays(values, col_idx, row_ptr,
                    shape: Tuple[int, int]) -> CRS:
    """The port's ``CRS`` from its three arrays."""
    values = np.asarray(values)
    col_idx, row_ptr = np.asarray(col_idx), np.asarray(row_ptr)
    m = int(shape[0])
    if values.ndim != 1 or values.shape != col_idx.shape \
            or row_ptr.shape != (m + 1,):
        raise ValueError(f"CRS arrays disagree: values {values.shape}, "
                         f"col_idx {col_idx.shape}, row_ptr {row_ptr.shape} "
                         f"for {m} rows")
    return CRS(values, col_idx.astype(np.int32), row_ptr.astype(np.int64),
               (m, int(shape[1])))


def incrs_from_arrays(values, col_idx, row_ptr, shape: Tuple[int, int],
                      counters, section: int, block: int) -> InCRS:
    """The port's ``InCRS`` from the CRS arrays and packed counter words."""
    counters = np.asarray(counters)
    if counters.dtype != np.uint32 or counters.ndim != 3 \
            or counters.shape[-1] != 2:
        raise ValueError(f"counters must be (M, n_sections, 2) uint32, got "
                         f"{counters.shape} {counters.dtype}")
    return InCRS(crs_from_arrays(values, col_idx, row_ptr, shape), counters,
                 int(section), int(block))


def prepared_from_arrays(idx, val, shape: Tuple[int, int], section: int,
                         device=None) -> PreparedOperand:
    """The port's ``PreparedOperand`` on ``device`` from stripe arrays."""
    idx, val = np.asarray(idx), np.asarray(val)
    if idx.dtype != np.int32 or val.dtype != np.float32 \
            or idx.shape != val.shape or idx.ndim != 3:
        raise ValueError(f"stripes must be two (Mp, n_sections, smax) "
                         f"int32/float32 arrays, got {idx.shape} "
                         f"{idx.dtype} and {val.shape} {val.dtype}")
    dev = resolve_device(device)
    return PreparedOperand(torch.from_numpy(idx.copy()).to(dev),
                           torch.from_numpy(val.copy()).to(dev),
                           (int(shape[0]), int(shape[1])), int(section))


def rounds_from_arrays(idx, val, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A per-round prep ``(idx, val)`` (``ops.prep_rounds`` form) as the
    port's tensors on ``device``."""
    idx, val = np.asarray(idx), np.asarray(val)
    if idx.dtype != np.int32 or idx.ndim != 3 or idx.shape != val.shape \
            or val.dtype.kind != "f":
        raise ValueError(f"a round prep is an int32 idx and a float val of "
                         f"one (rows, n_rounds, rmax) shape, got {idx.shape} "
                         f"{idx.dtype} and {val.shape} {val.dtype}")
    dev = resolve_device(device)
    return (torch.from_numpy(idx.copy()).to(dev),
            torch.from_numpy(val.copy()).to(dev))
