"""InCRS: Indexed Compressed Row Storage (the paper's section III format).

CRS plus one 64-bit counter word per (row, section):

  bits [0, prefix_bits)                         : non-zeros of the row BEFORE
                                                  this section
  bits [prefix_bits + k*count_bits, +count_bits): non-zeros INSIDE block k of
                                                  this section

Paper defaults: section S=256 columns, block b=32, prefix 16 bits, 6 bits
per block count, so 16 + 8*6 = 64 bits. The word is stored as two uint32
halves, bit for bit the layout of ``repro.core.incrs``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .crs import CRS

S_DEFAULT = 256
B_DEFAULT = 32
PREFIX_BITS = 16
COUNT_BITS = 6


def _pack64(prefix: np.ndarray, blocks: np.ndarray,
            prefix_bits: int = PREFIX_BITS, count_bits: int = COUNT_BITS
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Pack (prefix, blocks[..., n_blocks]) into (lo32, hi32) uint32 words."""
    word = prefix.astype(np.uint64)
    nb = blocks.shape[-1]
    if prefix_bits + nb * count_bits > 64:
        raise ValueError(
            f"counter-vector must fit a 64-bit word: prefix_bits="
            f"{prefix_bits} + {nb} blocks x count_bits={count_bits}")
    for k in range(nb):
        word = word | (blocks[..., k].astype(np.uint64)
                       << np.uint64(prefix_bits + k * count_bits))
    lo = (word & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (word >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def _unpack64(lo: np.ndarray, hi: np.ndarray, n_blocks: int,
              prefix_bits: int = PREFIX_BITS, count_bits: int = COUNT_BITS
              ) -> Tuple[np.ndarray, np.ndarray]:
    word = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    prefix = (word & np.uint64((1 << prefix_bits) - 1)).astype(np.int64)
    blocks = np.stack(
        [((word >> np.uint64(prefix_bits + k * count_bits))
          & np.uint64((1 << count_bits) - 1)).astype(np.int64)
         for k in range(n_blocks)], axis=-1)
    return prefix, blocks


@dataclasses.dataclass
class InCRS:
    """CRS + packed counter-vectors ``counters`` of shape (M, n_sections, 2)
    (uint32 lo/hi halves of the 64-bit counter word)."""

    crs: CRS
    counters: np.ndarray          # (M, n_sections, 2) uint32
    section: int = S_DEFAULT      # S
    block: int = B_DEFAULT        # b

    @property
    def shape(self):
        return self.crs.shape

    @property
    def n_sections(self) -> int:
        return self.counters.shape[1]

    @property
    def n_blocks(self) -> int:
        return self.section // self.block

    @staticmethod
    def from_crs(crs: CRS, section: int = S_DEFAULT, block: int = B_DEFAULT,
                 prefix_bits: int = PREFIX_BITS,
                 count_bits: int = COUNT_BITS) -> "InCRS":
        m, n = crs.shape
        if section % block != 0:
            raise ValueError(
                f"section={section} must be a multiple of block={block}")
        n_blocks = section // block
        if block > (1 << count_bits) - 1:
            raise ValueError(
                f"block count {block} must fit count_bits={count_bits} "
                f"(max {(1 << count_bits) - 1})")
        n_sections = -(-n // section)
        blocks = np.zeros((m, n_sections, n_blocks), dtype=np.int64)
        if crs.nnz:
            row_of = np.repeat(np.arange(m),
                               np.diff(crs.row_ptr).astype(np.int64))
            cols = crs.col_idx.astype(np.int64)
            np.add.at(blocks, (row_of, cols // section,
                               (cols % section) // block), 1)
        # prefix[i, t] = non-zeros before section t in row i: the exclusive
        # cumulative sum of the per-section counts.
        per_sec = blocks.sum(axis=-1)
        prefix = np.zeros((m, n_sections), dtype=np.int64)
        prefix[:, 1:] = np.cumsum(per_sec, axis=1)[:, :-1]
        if prefix.max(initial=0) >= (1 << prefix_bits):
            raise ValueError("row has more NZs than prefix field can count "
                             f"({prefix.max()} >= 2^{prefix_bits})")
        lo, hi = _pack64(prefix, blocks, prefix_bits, count_bits)
        return InCRS(crs, np.stack([lo, hi], axis=-1), section, block)

    @staticmethod
    def from_dense(dense: np.ndarray, section: int = S_DEFAULT,
                   block: int = B_DEFAULT) -> "InCRS":
        return InCRS.from_crs(CRS.from_dense(dense), section, block)

    def counters_unpacked(self) -> Tuple[np.ndarray, np.ndarray]:
        """Batch-unpack every counter word: (prefix (M, n_sections),
        blocks (M, n_sections, n_blocks))."""
        return _unpack64(self.counters[..., 0], self.counters[..., 1],
                         self.n_blocks)
