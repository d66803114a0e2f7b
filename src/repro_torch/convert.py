"""Carry an operand's state across from the JAX package.

The system has no weights; its state is the sparse operand. These take the
fields of a ``repro`` ``InCRS`` or ``PreparedOperand`` as numpy arrays
(``np.asarray`` of each) and build the port's objects from them, so both
packages can be fed the same operand.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .core.crs import CRS
from .core.incrs import InCRS
from .kernels.ops import PreparedOperand, resolve_device


def incrs_from_arrays(values, col_idx, row_ptr, shape: Tuple[int, int],
                      counters, section: int, block: int) -> InCRS:
    """The port's ``InCRS`` from the CRS arrays and packed counter words."""
    counters = np.asarray(counters)
    if counters.dtype != np.uint32 or counters.ndim != 3 \
            or counters.shape[-1] != 2:
        raise ValueError(f"counters must be (M, n_sections, 2) uint32, got "
                         f"{counters.shape} {counters.dtype}")
    crs = CRS(np.asarray(values), np.asarray(col_idx, dtype=np.int32),
              np.asarray(row_ptr, dtype=np.int64),
              (int(shape[0]), int(shape[1])))
    return InCRS(crs, counters, int(section), int(block))


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
