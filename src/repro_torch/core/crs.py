"""Compressed Row Storage (CRS): the paper's baseline sparse format.

Host-side numpy representation with explicit memory-access (MA)
accounting, the port's own copy of ``repro.core.crs``: the paper's Table I
/ Table II / Fig. 3 memory-access models, including full address traces
for the cache simulator in ``core/cache_sim.py``.

Address-space model (word addressed, 1 word = 8 bytes unless noted):
  values  live at  VAL_BASE + k
  col_idx live at  IDX_BASE + k
  row_ptr live at  PTR_BASE + i
Counter-vectors (InCRS) live in their own region, see ``core/incrs.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

# Word-addressed region bases, far enough apart that regions never overlap
# for the dataset sizes simulated (< 2^26 words each).
PTR_BASE = 0
IDX_BASE = 1 << 27
VAL_BASE = 1 << 28
CTR_BASE = 1 << 29
WORD_BYTES = 8


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

    @property
    def density(self) -> float:
        m, n = self.shape
        return self.nnz / float(m * n) if m * n else 0.0

    def storage_words(self) -> int:
        """CRS storage in words: one word per value + one per column index
        (the paper's ``~ 2 M N D words``) + the row-pointer vector."""
        return 2 * self.nnz + len(self.row_ptr)

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

    # ------------------------------------------------------------------
    def locate(self, i: int, j: int, trace: Optional[List[int]] = None
               ) -> Tuple[float, int]:
        """Read ``B[i][j]`` the CRS way: a linear scan of row ``i``'s
        non-zeros until column ``j`` is reached (paper section II-B: on
        average ~ N D / 2 accesses).

        Returns ``(value, memory_accesses)``; appends word addresses to
        ``trace`` if given. The row_ptr read counts as one access (the
        [i, i+1] pair are adjacent words, one lookup in the paper)."""
        ma = 1
        if trace is not None:
            trace.append(PTR_BASE + i)
        s, e = int(self.row_ptr[i]), int(self.row_ptr[i + 1])
        for k in range(s, e):
            ma += 1
            if trace is not None:
                trace.append(IDX_BASE + k)
            c = int(self.col_idx[k])
            if c == j:
                ma += 1
                if trace is not None:
                    trace.append(VAL_BASE + k)
                return float(self.values[k]), ma
            if c > j:
                return 0.0, ma
        return 0.0, ma

    def get_column(self, j: int, trace: Optional[List[int]] = None
                   ) -> Tuple[np.ndarray, int]:
        """Gather column ``j`` (dense) with one ``locate`` an element: the
        column-order access SpMM needs on its second operand."""
        m = self.shape[0]
        col = np.zeros(m, dtype=self.values.dtype)
        ma = 0
        for i in range(m):
            col[i], a = self.locate(i, j, trace)
            ma += a
        return col, ma

    def get_row(self, i: int, trace: Optional[List[int]] = None):
        """Row-order access, the natural direction: one access a word."""
        s, e = int(self.row_ptr[i]), int(self.row_ptr[i + 1])
        ma = 1 + 2 * (e - s)
        if trace is not None:
            trace.append(PTR_BASE + i)
            for k in range(s, e):
                trace.append(IDX_BASE + k)
                trace.append(VAL_BASE + k)
        return self.col_idx[s:e], self.values[s:e], ma


def expected_ma_crs(n_cols: int, density: float) -> float:
    """Table I: accesses to locate one element in CRS ~ N D / 2."""
    return 0.5 * n_cols * density


def expected_ma_coo(m: int, n: int, density: float) -> float:
    """Table I: COO/SLL ~ M N D / 2."""
    return 0.5 * m * n * density


def expected_ma_jad(n_cols: int, density: float) -> float:
    """Table I: JAD ~ N D (each scanned non-zero costs an extra jadPtr
    lookup)."""
    return float(n_cols) * density
