"""Compressed Row Storage (CRS): the paper's baseline sparse format.

Host-side numpy representation, the port's own copy of the fields and
constructors the InCRS serving and training paths need
(``repro.core.crs`` keeps the memory-access accounting used by the
paper-table simulators).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class CRS:
    """values/col_idx per non-zero, row_ptr per row (+1 sentinel)."""

    values: np.ndarray    # (nnz,) float
    col_idx: np.ndarray   # (nnz,) int32, sorted within each row
    row_ptr: np.ndarray   # (M+1,) int64
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @staticmethod
    def from_dense(dense: np.ndarray) -> "CRS":
        m, n = dense.shape
        rows, cols = np.nonzero(dense)
        order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]
        values = dense[rows, cols].astype(dense.dtype)
        row_ptr = np.zeros(m + 1, dtype=np.int64)
        np.add.at(row_ptr, rows + 1, 1)
        row_ptr = np.cumsum(row_ptr)
        return CRS(values, cols.astype(np.int32), row_ptr, (m, n))

    @staticmethod
    def from_mask(dense: np.ndarray, mask: np.ndarray) -> "CRS":
        """CRS over an explicit occupancy mask: a slot where ``mask`` is
        True is live even when its value is exactly 0.0 (``from_dense``
        would drop it). Non-zeros come in the row-major order of
        ``from_dense``, so ``mask = dense != 0`` packs the same CRS. Values
        are f32."""
        m, n = dense.shape
        if mask.shape != (m, n):
            raise ValueError(f"mask shape {mask.shape} != dense shape "
                             f"{(m, n)}")
        rows, cols = np.nonzero(mask)                # C order = (row, col)
        values = dense[rows, cols].astype(np.float32)
        row_ptr = np.zeros(m + 1, dtype=np.int64)
        row_ptr[1:] = np.cumsum(np.bincount(rows, minlength=m))
        return CRS(values, cols.astype(np.int32), row_ptr, (m, n))

    def to_dense(self) -> np.ndarray:
        m, n = self.shape
        out = np.zeros((m, n), dtype=self.values.dtype)
        rows = np.repeat(np.arange(m), np.diff(self.row_ptr).astype(np.int64))
        out[rows, self.col_idx] = self.values
        return out
