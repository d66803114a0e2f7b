"""The BSR sparse linear family: block-sparse weights on the BSR kernel.

The port of the BSR half of ``repro.sparse.linear``, forward only:

  y = x @ W            with W^T stored as BSR (out-major blocks)

``SparseLinearMeta`` is the JAX meta field for field (the kernel block
lists with their zero tiles, the transposed lists and the permutation
``t_perm`` that the backward pass will use), so the training slice can
add the VJP on the same metadata. The backward pass (dx through a second
BSR product over the transposed lists, dW restricted to the live blocks)
is not ported: ``_SparseMM.backward`` raises.

The metadata is static host data (tuples). The device index tensors a
launch needs (``row_of``, ``col_of`` and the block-row run starts) are
made once per meta and device and kept on the meta, never per call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..core.bsr import BSR
from ..kernels import bsr_spmm as _bsr_k
from ..kernels import ops
from .pattern import (FamilyOps, SparsityPattern, expand_block_mask,
                      register_family)


@dataclasses.dataclass(frozen=True)
class SparseLinearMeta:
    """Static metadata for one sparse weight.

    ``row_of``/``col_of`` (and their ``t_`` twins) are the KERNEL block
    lists: they include one explicit zero tile per empty block-row (the
    kernel writes each output block-row from its block run) plus the
    trailing sentinel. ``vpos[q]`` is the slot of real (trainable) block
    ``q`` inside that padded sequence; pad slots hold zeros.
    """
    d_in: int
    d_out: int
    block: int
    row_of: Tuple[int, ...]          # fwd BSR (W^T: out-major) + sentinel
    col_of: Tuple[int, ...]
    vpos: Tuple[int, ...]            # real block -> slot in padded fwd list
    t_perm: Tuple[int, ...]          # permutation fwd blocks -> bwd blocks
    t_row_of: Tuple[int, ...]        # bwd BSR (W: in-major) + sentinel
    t_col_of: Tuple[int, ...]
    t_vpos: Tuple[int, ...]          # real block -> slot in padded bwd list
    # the pattern this meta was packed for; compare=False keeps it out of
    # the generated __eq__/__hash__
    pattern: Any = dataclasses.field(default=None, compare=False,
                                     repr=False)
    # device -> (row_of, col_of, row_start) int32 tensors, made once
    _device: Dict[str, Tuple[torch.Tensor, ...]] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def nnz(self) -> int:
        return len(self.vpos)

    @property
    def n_block_rows(self) -> int:
        return self.d_out // self.block

    @property
    def n_block_rows_t(self) -> int:
        return self.d_in // self.block

    def kernel_index(self, device: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(row_of, col_of, row_start) int32 on ``device`` for the forward
        launch, made on first use and kept."""
        key = str(device)
        hit = self._device.get(key)
        if hit is None:
            row_of = np.asarray(self.row_of, np.int32)
            row_start = _bsr_k.block_row_starts(row_of[:-1],
                                                self.n_block_rows)
            hit = self._device[key] = tuple(
                torch.from_numpy(x).to(device) for x in
                (row_of, np.asarray(self.col_of, np.int32), row_start))
        return hit


@dataclasses.dataclass
class SparseLinearParams:
    values: torch.Tensor             # (nnz, block, block) — W^T blocks
    meta: SparseLinearMeta

    @property
    def pattern(self) -> "SparsityPattern | None":
        return self.meta.pattern


_bsr_meta = ops.bsr_kernel_meta


def real_blocks(meta: SparseLinearMeta) -> Tuple[np.ndarray, np.ndarray]:
    """(block-row, block-col) of each real (trainable) block, in values
    order — the padded kernel lists minus the injected zero tiles."""
    vpos = np.asarray(meta.vpos, dtype=np.int64)
    return (np.asarray(meta.row_of[:-1], np.int32)[vpos],
            np.asarray(meta.col_of, np.int32)[vpos])


def _bsr_from_mask(w: np.ndarray, mask: np.ndarray, block: int,
                   dtype=torch.float32, *, device=None,
                   _pattern: "SparsityPattern | None" = None
                   ) -> SparseLinearParams:
    """Pack a dense W (d_in, d_out) under an explicit block-occupancy mask
    of W^T (out-major, shape (d_out//block, d_in//block)), values on
    ``device``. ``_pattern`` rides in instead of one minted from
    ``mask``."""
    d_in, d_out = w.shape
    wt = np.ascontiguousarray(np.asarray(w).T)         # (out, in)
    fwd = BSR.from_mask(wt, mask, (block, block))      # W^T blocks
    bwd = BSR.from_mask(np.ascontiguousarray(np.asarray(w)),
                        mask.T, (block, block))        # W blocks
    row_of, col_of, vpos = _bsr_meta(fwd)
    t_row_of, t_col_of, t_vpos = _bsr_meta(bwd)
    # permutation: fwd block p at (r, c) -> bwd block at (c, r)
    fwd_pos = {}
    p = 0
    for r in range(fwd.n_block_rows):
        for q in range(fwd.row_ptr[r], fwd.row_ptr[r + 1]):
            fwd_pos[(r, int(fwd.col_idx[q]))] = p
            p += 1
    perm = []
    for r in range(bwd.n_block_rows):
        for q in range(bwd.row_ptr[r], bwd.row_ptr[r + 1]):
            perm.append(fwd_pos[(int(bwd.col_idx[q]), r)])
    if _pattern is None:
        _pattern = SparsityPattern(expand_block_mask(mask, block))
    meta = SparseLinearMeta(
        d_in, d_out, block,
        tuple(int(x) for x in row_of), tuple(int(x) for x in col_of),
        tuple(int(x) for x in vpos),
        tuple(perm),
        tuple(int(x) for x in t_row_of), tuple(int(x) for x in t_col_of),
        tuple(int(x) for x in t_vpos), pattern=_pattern)
    _pattern.packed["bsr"] = meta
    values = torch.from_numpy(np.ascontiguousarray(fwd.values)).to(dtype)
    return SparseLinearParams(values.to(ops.resolve_device(device)), meta)


# ----------------------------------------------------------------------
def _pad_slots(values: torch.Tensor, meta: SparseLinearMeta) -> torch.Tensor:
    """Scatter real block values into the zero-tile-padded kernel slot
    sequence (contiguous; the values themselves when no block-row was
    empty). A bound plan does this once, at bind."""
    n_slots = len(meta.col_of)
    if n_slots == values.shape[0]:
        return values.contiguous()
    slots = values.new_zeros((n_slots,) + tuple(values.shape[1:]))
    vpos = torch.as_tensor(meta.vpos, dtype=torch.long, device=values.device)
    slots[vpos] = values
    return slots


def _bsr_forward(meta: SparseLinearMeta, slots: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """C[d_out, N] = W^T @ B through the BSR kernel, from the padded
    slots; B is made contiguous here only if it is not already."""
    row_of, col_of, row_start = meta.kernel_index(slots.device)
    return ops.bsr_matmul_arrays(row_of, col_of, slots, b.contiguous(),
                                 n_block_rows=meta.n_block_rows,
                                 row_start=row_start)


class _SparseMM(torch.autograd.Function):
    """y[T, out] = x[T, in] @ W, W^T stored as BSR values."""

    @staticmethod
    def forward(ctx, values, x, meta):
        return _bsr_forward(meta, _pad_slots(values, meta), x.T).T

    @staticmethod
    def backward(ctx, dy):
        raise NotImplementedError(
            "the BSR backward pass (dx through the transposed block lists, "
            "dW over the live blocks) is the training slice of the port, "
            "not ported yet (ROADMAP queue 1 item 2)")


def _sparse_mm(values: torch.Tensor, x: torch.Tensor,
               meta: SparseLinearMeta) -> torch.Tensor:
    return _SparseMM.apply(values, x, meta)


def _bsr_apply(p: SparseLinearParams, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d_in) -> (..., d_out) through the BSR kernel."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, p.meta.d_in)
    y = _sparse_mm(p.values, x2, p.meta)
    return y.reshape(*lead, p.meta.d_out)


def to_dense(p: SparseLinearParams) -> np.ndarray:
    """Densify W (d_in, d_out) from the current values (host numpy)."""
    blk = p.meta.block
    d_in, d_out = p.meta.d_in, p.meta.d_out
    vals = p.values.detach().cpu()
    if vals.dtype == torch.bfloat16:          # numpy has no bfloat16
        vals = vals.float()
    vals = vals.numpy()
    tiles = np.zeros((d_out // blk, d_in // blk, blk, blk), vals.dtype)
    rows, cols = real_blocks(p.meta)
    tiles[rows, cols] = vals
    return np.ascontiguousarray(
        tiles.transpose(0, 2, 1, 3).reshape(d_out, d_in).T)


def _bsr_pack_values(meta: SparseLinearMeta, w: np.ndarray) -> np.ndarray:
    """Dense W -> (nnz, block, block) W^T tiles of meta's REAL blocks."""
    blk = meta.block
    wt = np.ascontiguousarray(np.asarray(w, np.float32).T)
    tiles = wt.reshape(meta.n_block_rows, blk, meta.d_in // blk,
                       blk).transpose(0, 2, 1, 3)
    rows, cols = real_blocks(meta)
    return np.ascontiguousarray(tiles[rows, cols])


register_family(SparseLinearParams, FamilyOps(
    "bsr", to_dense=lambda n: np.asarray(to_dense(n), np.float32)))
