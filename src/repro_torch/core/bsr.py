"""Block-CSR (BSR): whole dense tiles of a matrix, kept or skipped.

The port's copy of ``repro.core.bsr`` (numpy only, equal bit for bit).
BSR keeps, per row of blocks, the paper's InCRS counter idea: ``row_ptr``
IS the prefix counter ("how many non-zero blocks before this block-row")
and ``col_idx`` locates each useful block — O(1) metadata per block
instead of scanning. ``kernels/bsr_spmm.py`` consumes the block lists
that ``ops.prep_bsr`` derives from it.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class BSR:
    """Block-sparse matrix of logical shape ``shape``; blocks are dense
    (bm, bk) tiles.

    values  : (n_blocks_nz, bm, bk)
    col_idx : (n_blocks_nz,) int32 — block-column of each stored block
    row_ptr : (n_block_rows + 1,) int32 — prefix counters (InCRS analogue)
    """

    values: np.ndarray
    col_idx: np.ndarray
    row_ptr: np.ndarray
    shape: Tuple[int, int]
    block: Tuple[int, int]

    @property
    def n_block_rows(self) -> int:
        return self.shape[0] // self.block[0]

    @property
    def n_block_cols(self) -> int:
        return self.shape[1] // self.block[1]

    @property
    def nnz_blocks(self) -> int:
        return int(self.values.shape[0])

    @property
    def block_density(self) -> float:
        return self.nnz_blocks / float(self.n_block_rows * self.n_block_cols)

    # ------------------------------------------------------------------
    @staticmethod
    def from_dense(dense: np.ndarray, block: Tuple[int, int],
                   keep_threshold: float = 0.0) -> "BSR":
        """Blocks whose max-abs exceeds ``keep_threshold`` are stored."""
        m, k = dense.shape
        bm, bk = block
        if m % bm != 0 or k % bk != 0:
            raise ValueError(
                f"dense shape {(m, k)} not divisible by block {block}")
        nbr, nbc = m // bm, k // bk
        tiles = dense.reshape(nbr, bm, nbc, bk).transpose(0, 2, 1, 3)
        occupancy = np.abs(tiles).max(axis=(2, 3)) > keep_threshold
        row_ptr = np.zeros(nbr + 1, dtype=np.int32)
        row_ptr[1:] = np.cumsum(occupancy.sum(axis=1))
        rows, cols = np.nonzero(occupancy)
        values = tiles[rows, cols].astype(dense.dtype)
        return BSR(values, cols.astype(np.int32), row_ptr, (m, k), (bm, bk))

    @staticmethod
    def from_mask(dense: np.ndarray, mask: np.ndarray,
                  block: Tuple[int, int]) -> "BSR":
        """Keep exactly the blocks where ``mask[br, bc]`` is True."""
        m, k = dense.shape
        bm, bk = block
        nbr, nbc = m // bm, k // bk
        if mask.shape != (nbr, nbc):
            raise ValueError(
                f"mask shape {mask.shape} != block grid {(nbr, nbc)}")
        tiles = dense.reshape(nbr, bm, nbc, bk).transpose(0, 2, 1, 3)
        row_ptr = np.zeros(nbr + 1, dtype=np.int32)
        row_ptr[1:] = np.cumsum(mask.sum(axis=1))
        rows, cols = np.nonzero(mask)
        values = tiles[rows, cols].astype(dense.dtype)
        return BSR(values, cols.astype(np.int32), row_ptr, (m, k), (bm, bk))

    def to_dense(self) -> np.ndarray:
        bm, bk = self.block
        out = np.zeros(self.shape, dtype=self.values.dtype)
        for br in range(self.n_block_rows):
            s, e = self.row_ptr[br], self.row_ptr[br + 1]
            for idx in range(s, e):
                bc = self.col_idx[idx]
                out[br * bm:(br + 1) * bm, bc * bk:(bc + 1) * bk] = \
                    self.values[idx]
        return out

    # ------------------------------------------------------------------
    def padded(self, max_blocks_per_row: int | None = None):
        """Dense-padded form for fixed-shape kernels: per block-row,
        ``(idx, cnt)`` with idx padded to the max row degree. Padded slots
        point at block 0 with a zero mask (they are skipped via ``cnt``)."""
        deg = np.diff(self.row_ptr)
        width = int(deg.max(initial=0)) if max_blocks_per_row is None \
            else max_blocks_per_row
        width = max(width, 1)
        nbr = self.n_block_rows
        idx = np.zeros((nbr, width), dtype=np.int32)
        blk = np.zeros((nbr, width), dtype=np.int32)  # index into values
        for br in range(nbr):
            s, e = self.row_ptr[br], self.row_ptr[br + 1]
            idx[br, : e - s] = self.col_idx[s:e]
            blk[br, : e - s] = np.arange(s, e, dtype=np.int32)
        return idx, blk, deg.astype(np.int32)


def magnitude_block_mask(dense: np.ndarray, block: Tuple[int, int],
                         density: float) -> np.ndarray:
    """Keep the top-``density`` fraction of blocks by Frobenius norm —
    the pruning used by ``sparse.SparseLinear``."""
    m, k = dense.shape
    bm, bk = block
    nbr, nbc = m // bm, k // bk
    tiles = dense.reshape(nbr, bm, nbc, bk).transpose(0, 2, 1, 3)
    score = np.square(tiles).sum(axis=(2, 3))
    n_keep = max(1, int(round(density * nbr * nbc)))
    thresh = np.partition(score.ravel(), -n_keep)[-n_keep]
    mask = score >= thresh
    # break ties deterministically so exactly n_keep survive when possible
    extra = mask.sum() - n_keep
    if extra > 0:
        tied = np.argwhere((score == thresh) & mask)
        for r, c in tied[:extra]:
            mask[r, c] = False
    # every block-row keeps >= 1 block so no output row is dead
    for br in range(nbr):
        if not mask[br].any():
            mask[br, int(np.argmax(score[br]))] = True
    return mask
