"""Sparse linear layers, trainable: the BSR and InCRS families.

The port of ``repro.sparse.linear``. Its families are
``torch.autograd.Function``s whose forward and dx run the port's CUDA
kernels (on CPU tensors, their plain versions):

  BSR    y  = x @ W     the BSR kernel over W^T's blocks (out-major)
         dx = dy @ W^T  the BSR kernel again, over the TRANSPOSED block
                        lists (a permutation of blocks + a swap of block
                        dims, fixed at pack time)
         dW             per-block products of the REAL blocks only; the
                        zero tiles put in for empty block-rows stay frozen
  InCRS  y  = x @ W     the fused InCRS kernel over W^T's section stripes
         dx = dy @ W^T  the fused kernel over the TRANSPOSED stripes, whose
                        values are a gather (``t_gather``) of the forward
                        values
         dW             restricted to the live slots: x's columns gathered
                        by the stripe ``idx``, one section at a time, T
                        multiply-adds a slot; pad slots get exactly 0.0

dx runs only when the input needs a gradient. dW is torch ops, as it is
jnp (no Pallas kernel) in the JAX package. The row-sharded InCRS family
(``ShardedInCRSLinearParams``) splits W^T's output rows into one panel a
shard of a ``launch.mesh.Mesh`` and runs the InCRS products shard by shard,
dx summed over the shards in shard order.

``SparseLinearMeta`` is static host data (tuples); the device index
tensors a launch or a backward pass needs are made once per meta and
device and kept on the meta. ``InCRSLinearMeta`` holds its stripe
indices as int32 tensors on the device of the values.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.bsr import BSR
from ..core.crs import CRS
from ..core.incrs import B_DEFAULT, S_DEFAULT, InCRS
from ..kernels import bsr_spmm as _bsr_k
from ..kernels import ops
from .pattern import (FamilyOps, SparsityPattern, expand_block_mask,
                      magnitude_mask, register_family)


class _GradIndex(NamedTuple):
    """int64 device index tensors of the BSR backward pass."""
    vpos: torch.Tensor       # real block -> slot in the padded fwd list
    t_perm: torch.Tensor     # bwd block -> its fwd block
    t_vpos: torch.Tensor     # real block -> slot in the padded bwd list
    rows: torch.Tensor       # block-row of each real block (W^T)
    cols: torch.Tensor       # block-column of each real block (W^T)


@dataclasses.dataclass(frozen=True)
class SparseLinearMeta:
    """Static metadata for one sparse weight.

    ``row_of``/``col_of`` (and their ``t_`` twins) are the KERNEL block
    lists: they include one explicit zero tile per empty block-row (the
    kernel writes each output block-row from its block run) plus the
    trailing sentinel. ``vpos[q]`` is the slot of real (trainable) block
    ``q`` inside that padded sequence; pad slots hold zeros and receive no
    gradient.
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
    # (what, device) -> device tensors, made once
    _device: Dict[Tuple[str, str], Any] = dataclasses.field(
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

    def _lists(self, row_of, col_of, n_block_rows, device, key):
        hit = self._device.get((key, str(device)))
        if hit is None:
            row_of = np.asarray(row_of, np.int32)
            row_start = _bsr_k.block_row_starts(row_of[:-1], n_block_rows)
            hit = self._device[(key, str(device))] = tuple(
                torch.from_numpy(x).to(device) for x in
                (row_of, np.asarray(col_of, np.int32), row_start))
        return hit

    def kernel_index(self, device: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(row_of, col_of, row_start) int32 on ``device`` for the forward
        launch, made on first use and kept."""
        return self._lists(self.row_of, self.col_of, self.n_block_rows,
                           device, "fwd")

    def kernel_index_t(self, device: torch.device
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(t_row_of, t_col_of, t_row_start) int32 on ``device`` for dx's
        launch over the transposed lists, made on first use and kept."""
        return self._lists(self.t_row_of, self.t_col_of, self.n_block_rows_t,
                           device, "bwd")

    def grad_index(self, device: torch.device) -> _GradIndex:
        """The backward pass's index tensors on ``device``, made once."""
        key = ("grad", str(device))
        hit = self._device.get(key)
        if hit is None:
            rows, cols = real_blocks(self)
            hit = self._device[key] = _GradIndex(*(
                torch.as_tensor(np.asarray(x, np.int64), device=device)
                for x in (self.vpos, self.t_perm, self.t_vpos, rows, cols)))
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
def _scatter_slots(values: torch.Tensor, vpos: torch.Tensor,
                   n_slots: int) -> torch.Tensor:
    """Real block values scattered into a zero-tile-padded kernel slot
    sequence (contiguous; the values themselves when nothing is
    padded)."""
    if n_slots == values.shape[0]:
        return values.contiguous()
    slots = values.new_zeros((n_slots,) + tuple(values.shape[1:]))
    slots[vpos] = values
    return slots


def _pad_slots(values: torch.Tensor, meta: SparseLinearMeta) -> torch.Tensor:
    """The forward kernel's padded slot sequence (contiguous; the values
    themselves when no block-row was empty). A bound plan does this once,
    at bind."""
    n_slots = len(meta.col_of)
    if n_slots == values.shape[0]:
        return values.contiguous()
    return _scatter_slots(values, meta.grad_index(values.device).vpos,
                          n_slots)


def _bsr_forward(meta: SparseLinearMeta, slots: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """C[d_out, N] = W^T @ B through the BSR kernel, from the padded
    slots; B is made contiguous here only if it is not already."""
    row_of, col_of, row_start = meta.kernel_index(slots.device)
    return ops.bsr_matmul_arrays(row_of, col_of, slots, b.contiguous(),
                                 n_block_rows=meta.n_block_rows,
                                 row_start=row_start)


def _bsr_dx(meta: SparseLinearMeta, values: torch.Tensor,
            dyt: torch.Tensor) -> torch.Tensor:
    """dx^T[d_in, T] = W @ dy^T: the BSR kernel over the transposed lists,
    whose blocks are the forward blocks permuted and transposed."""
    gi = meta.grad_index(values.device)
    tvals = values.index_select(0, gi.t_perm).transpose(1, 2)
    slots = _scatter_slots(tvals, gi.t_vpos, len(meta.t_col_of))
    row_of, col_of, row_start = meta.kernel_index_t(values.device)
    return ops.bsr_matmul_arrays(row_of, col_of, slots, dyt,
                                 n_block_rows=meta.n_block_rows_t,
                                 row_start=row_start)


def _bsr_dw(meta: SparseLinearMeta, x: torch.Tensor,
            dyt: torch.Tensor) -> torch.Tensor:
    """dW^T block p at (r, c) = dy[:, r-block]^T x[:, c-block], f32, for
    the real blocks only: the zero tiles stay frozen. ``dyt`` is dy^T,
    contiguous."""
    gi = meta.grad_index(dyt.device)
    blk, t = meta.block, dyt.shape[1]
    dyb = dyt.view(meta.n_block_rows, blk, t)
    xb = x.T.reshape(meta.n_block_rows_t, blk, t)
    return torch.bmm(dyb.index_select(0, gi.rows).to(torch.float32),
                     xb.index_select(0, gi.cols).to(torch.float32
                                                    ).transpose(1, 2))


class _SparseMM(torch.autograd.Function):
    """y[T, out] = x[T, in] @ W, W^T stored as BSR values."""

    @staticmethod
    def forward(ctx, values, x, meta):
        ctx.save_for_backward(values, x)
        ctx.meta = meta
        return _bsr_forward(meta, _pad_slots(values, meta), x.T).T

    @staticmethod
    def backward(ctx, dy):
        values, x = ctx.saved_tensors
        meta = ctx.meta
        dyt = dy.T.contiguous()                                # (out, T)
        dvals = dx = None
        if ctx.needs_input_grad[1]:
            dx = _bsr_dx(meta, values, dyt).T.to(x.dtype)
        if ctx.needs_input_grad[0]:
            dvals = _bsr_dw(meta, x, dyt).to(values.dtype)
        return dvals, dx, None


def _sparse_mm(values: torch.Tensor, x: torch.Tensor,
               meta: SparseLinearMeta) -> torch.Tensor:
    return _SparseMM.apply(values, x, meta)


def _bsr_apply(p: SparseLinearParams, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d_in) -> (..., d_out) through the BSR kernel;
    differentiable wrt ``p.values`` and ``x``."""
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


# ----------------------------------------------------------------------
# The InCRS family: element-level sparsity through the fused InCRS kernel.
@dataclasses.dataclass(frozen=True, eq=False)
class InCRSLinearMeta:
    """Static metadata of one trainable InCRS weight, the stripe indices
    on the device of the values. ``eq=False``: identity hash/eq."""
    fwd_idx: torch.Tensor     # (Op, Si, smax) int32 — W^T stripes, -1 pad
    bwd_idx: torch.Tensor     # (Ip, So, smax_t) int32 — W stripes, -1 pad
    t_gather: torch.Tensor    # (Ip*So*smax_t,) int32 — bwd slot -> flat fwd
    #                           slot (the one-past-the-end slot reads 0.0)
    d_in: int
    d_out: int
    section: int
    nnz: int                  # live non-zeros
    block: int = B_DEFAULT    # InCRS counter block
    pattern: Any = None       # the SparsityPattern of this meta


@dataclasses.dataclass
class InCRSLinearParams:
    values: torch.Tensor      # (Op, Si, smax) f32 — the trainable tensor
    meta: InCRSLinearMeta

    @property
    def pattern(self) -> "SparsityPattern | None":
        return self.meta.pattern


def meta_to(meta: Any, device: torch.device) -> Any:
    """A single-device meta with its device tensors on ``device``: ``meta``
    itself when they are there already, else a copy sharing its pattern
    (the copy is not registered as the pattern's packed meta)."""
    moved = {f.name: getattr(meta, f.name) for f in dataclasses.fields(meta)
             if isinstance(getattr(meta, f.name), torch.Tensor)}
    if all(t.device == device for t in moved.values()):
        return meta
    return dataclasses.replace(
        meta, **{k: t.to(device) for k, t in moved.items()})


def _transpose_gather(fwd_idx: np.ndarray, bwd_idx: np.ndarray,
                      section: int, d_in: int) -> np.ndarray:
    """Map every bwd stripe slot to the flat fwd slot holding the same
    non-zero (pad slots -> the extra zero slot at index fwd_idx.size).

    Keys are the global (out, in) coordinates: fwd slot (r, s, k) holds
    W^T[r, idx + s*section]; bwd slot (r', s', k') holds W[r', idx' +
    s'*section] = W^T[idx' + s'*section, r']. Both key lists are sorted
    (stably: they come in sorted runs) and matched rank for rank, the
    same map as the JAX packer's binary search.
    """
    r_f, s_f, _ = np.indices(fwd_idx.shape)
    fmask = fwd_idx >= 0
    fkey = (r_f[fmask].astype(np.int64) * d_in
            + fwd_idx[fmask] + s_f[fmask].astype(np.int64) * section)
    fpos = np.flatnonzero(fmask.ravel())
    order = np.argsort(fkey, kind="stable")
    fkey, fpos = fkey[order], fpos[order]
    r_b, s_b, _ = np.indices(bwd_idx.shape)
    bmask = bwd_idx >= 0
    bkey = ((bwd_idx[bmask].astype(np.int64)
             + s_b[bmask].astype(np.int64) * section) * d_in + r_b[bmask])
    border = np.argsort(bkey, kind="stable")
    if bkey.size != fkey.size or not np.array_equal(bkey[border], fkey):
        raise ValueError("fwd/bwd stripe non-zero sets must be transposes "
                         "of each other")
    t_gather = np.full(bwd_idx.size, fwd_idx.size, dtype=np.int32)
    t_gather[np.flatnonzero(bmask.ravel())[border]] = fpos
    return t_gather


def _resolve_pattern(w: np.ndarray, density, mask,
                     _pattern) -> SparsityPattern:
    """One rule for every constructor: an explicit pattern wins; else an
    explicit element mask of W (slots it keeps stay live even at value
    0.0); else a global-threshold magnitude selection at ``density``
    (None -> exactly the non-zeros)."""
    if _pattern is not None:
        return _pattern
    if mask is not None:
        if density is not None:
            raise ValueError("pass density OR mask, not both")
        return SparsityPattern(mask)
    return SparsityPattern(magnitude_mask(w, density))


def _pack_incrs(w: np.ndarray, pat: SparsityPattern, section: int,
                block: int, *, device=None) -> InCRSLinearParams:
    """Pack dense W values under ``pat`` into the trainable fused-kernel
    form on ``device`` (default CUDA): the stripes of W^T and of W, and
    the gather between them. The one InCRS packer; the constructors only
    decide where the pattern comes from."""
    dev = ops.resolve_device(device)
    d_in, d_out = w.shape
    if pat.shape != (d_in, d_out):
        raise ValueError(f"pattern mask shape {pat.shape} != weight shape "
                         f"{(d_in, d_out)}")
    w = np.ascontiguousarray(w, np.float32)
    incrs = InCRS.from_crs(
        CRS.from_mask(np.ascontiguousarray(w.T),
                      np.ascontiguousarray(pat.mask.T)),
        section=section, block=block)
    incrs_t = InCRS.from_crs(CRS.from_mask(w, pat.mask), section=section,
                             block=block)
    fwd_idx, fwd_val = ops.prep_sections(incrs, pad_rows_to=128,
                                         device="cpu")
    bwd_idx, _ = ops.prep_sections(incrs_t, pad_rows_to=128, device="cpu")
    t_gather = _transpose_gather(fwd_idx.numpy(), bwd_idx.numpy(), section,
                                 d_in)
    meta = InCRSLinearMeta(fwd_idx.to(dev), bwd_idx.to(dev),
                           torch.from_numpy(t_gather).to(dev), d_in, d_out,
                           section, incrs.crs.nnz, block=block, pattern=pat)
    pat.packed["incrs"] = meta
    return InCRSLinearParams(fwd_val.to(dev), meta)


def _incrs_from_dense(w: np.ndarray, density: Optional[float] = None,
                      section: Optional[int] = None,
                      block: Optional[int] = None, *,
                      mask: Optional[np.ndarray] = None, device=None,
                      _pattern: Optional[SparsityPattern] = None
                      ) -> InCRSLinearParams:
    """Pack a dense W (d_in, d_out), optionally magnitude-pruned to
    element ``density`` or under an explicit element ``mask`` of W whose
    slots stay live even at value 0.0, into the trainable form on
    ``device``."""
    section = S_DEFAULT if section is None else section
    block = B_DEFAULT if block is None else block
    w = np.asarray(w, np.float32)
    return _pack_incrs(w, _resolve_pattern(w, density, mask, _pattern),
                       section, block, device=device)


def _incrs_init(generator: torch.Generator, d_in: int, d_out: int,
                density: float, scale: float = 0.02,
                **kw) -> InCRSLinearParams:
    """Random-normal W (std ``scale``, drawn on the CPU from
    ``generator``), magnitude-pruned to ``density`` and packed."""
    w = torch.randn((d_in, d_out), generator=generator) * scale
    return _incrs_from_dense(w.numpy(), density, **kw)


def _incrs_stack_init(generator: torch.Generator, n_stages: int, d_in: int,
                      d_out: int, density: float, scale: float = 0.02,
                      **kw) -> InCRSLinearParams:
    """Shared-pattern parameter stack for pipeline stages: ONE InCRS
    pattern (stage 0's draw, magnitude-pruned to ``density``), so one meta
    serves every stage and the values stack along a leading stage axis;
    stages 1.. take independent normal values (std ``scale``, drawn on the
    CPU from ``generator``) on that pattern's live slots, pad slots 0.0."""
    p0 = _incrs_init(generator, d_in, d_out, density, scale, **kw)
    live = (p0.meta.fwd_idx >= 0).cpu()
    noise = torch.randn((n_stages - 1,) + tuple(p0.values.shape),
                        generator=generator) * scale
    rest = (noise * live[None]).to(p0.values.device)
    return InCRSLinearParams(torch.cat([p0.values[None], rest]), p0.meta)


def _incrs_product(idx: torch.Tensor, values: torch.Tensor,
                   shape: Tuple[int, int], section: int,
                   b: torch.Tensor) -> torch.Tensor:
    """C = A @ B through the fused kernel (``ops.spmm``'s ``auto``), A the
    stripes ``(idx, values)`` as they are now: never through
    ``ops.prepare_incrs``'s memo, which would serve older values."""
    return ops.spmm(ops.PreparedOperand(idx, values, shape, section), b)


def _incrs_dx(meta: InCRSLinearMeta, values: torch.Tensor,
              dyt: torch.Tensor) -> torch.Tensor:
    """dx^T[d_in, T] = W @ dy^T: the fused kernel over the transposed
    stripes, their values gathered from the forward ones (t_gather sends
    pad slots to the appended zero)."""
    flat = torch.cat([values.reshape(-1), values.new_zeros(1)])
    tvals = flat.index_select(0, meta.t_gather).view(meta.bwd_idx.shape)
    return _incrs_product(meta.bwd_idx, tvals, (meta.d_in, meta.d_out),
                          meta.section, dyt)


def _stripe_dw(idx: torch.Tensor, section: int, x: torch.Tensor,
               dy: torch.Tensor) -> torch.Tensor:
    """dW^T restricted to the live slots of one stripe set.

    dW^T[r, c] = sum_t dy[t, r] x[t, c], evaluated ONLY at the live
    slots: x's columns gathered by the stripe idx, one T-long
    multiply-add a slot. One section at a time, so the gathered x peaks at
    (Op, smax, T) and is freed before the next. Pad slots get 0.0."""
    op, n_sections, smax = idx.shape
    t = x.shape[0]
    kp = n_sections * section
    xpt = torch.nn.functional.pad(x.to(torch.float32),
                                  (0, kp - x.shape[1])).T.contiguous()
    dyp = torch.nn.functional.pad(dy.to(torch.float32),
                                  (0, op - dy.shape[1]))          # (T, Op)
    dvals = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    for s in range(n_sections):
        gs = idx[:, s]
        gcol = torch.where(gs >= 0, gs + s * section, 0)
        xg = xpt.index_select(0, gcol.reshape(-1)).view(op, smax, t)
        dvals[:, s] = torch.einsum("rkt,tr->rk", xg, dyp)
        del xg
    return dvals.masked_fill_(idx < 0, 0.0)


class _InCRSMM(torch.autograd.Function):
    """y[T, d_out] = x[T, d_in] @ W, W^T stored as section stripes."""

    @staticmethod
    def forward(ctx, values, x, meta):
        ctx.save_for_backward(values, x)
        ctx.meta = meta
        return _incrs_product(meta.fwd_idx, values, (meta.d_out, meta.d_in),
                              meta.section, x.T).T

    @staticmethod
    def backward(ctx, dy):
        values, x = ctx.saved_tensors
        meta = ctx.meta
        dvals = dx = None
        if ctx.needs_input_grad[1]:
            dx = _incrs_dx(meta, values, dy.T).T.to(x.dtype)
        if ctx.needs_input_grad[0]:
            dvals = _stripe_dw(meta.fwd_idx, meta.section, x,
                               dy).to(values.dtype)
        return dvals, dx, None


def _incrs_apply(p: InCRSLinearParams, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d_in) -> (..., d_out) through the fused InCRS kernel;
    differentiable wrt ``p.values`` and ``x``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, p.meta.d_in)
    y = _InCRSMM.apply(p.values, x2, p.meta)
    return y.reshape(*lead, p.meta.d_out)


def incrs_to_dense_weight(p: InCRSLinearParams) -> np.ndarray:
    """Densify W (d_in, d_out) from the CURRENT values (host numpy)."""
    idx = p.meta.fwd_idx.cpu().numpy()
    vals = p.values.detach().cpu().numpy()
    wt = np.zeros((idx.shape[0], idx.shape[1] * p.meta.section), np.float32)
    r, s, k = np.nonzero(idx >= 0)
    wt[r, idx[r, s, k] + s * p.meta.section] = vals[r, s, k]
    return wt[:p.meta.d_out, :p.meta.d_in].T


def _incrs_pack_values(meta: InCRSLinearMeta, w: np.ndarray) -> np.ndarray:
    """Dense W -> (Op, Si, smax) stripe values of meta's live slots."""
    idx = meta.fwd_idx.cpu().numpy()
    wt = np.asarray(w, np.float32).T
    kp = idx.shape[1] * meta.section
    wtp = np.zeros((idx.shape[0], kp), np.float32)
    wtp[:wt.shape[0], :wt.shape[1]] = wt
    vals = np.zeros(idx.shape, np.float32)
    r, s, k = np.nonzero(idx >= 0)
    vals[r, s, k] = wtp[r, idx[r, s, k] + s * meta.section]
    return vals


# ----------------------------------------------------------------------
# Row-sharded InCRS: W^T (d_out, d_in) is split into n_shards contiguous
# OUTPUT-row panels, one per shard device of a ``launch.mesh.Mesh``, all
# driven by this process:
#
#   y  = x @ W      each shard's fused SpMM over its own stripe panel, on
#                   its device; the (T, shard_width) panels concatenate
#                   along d_out on x's device
#   dx = dy @ W^T   each shard's fused SpMM over its TRANSPOSED stripes
#                   with its dy panel, then summed on x's device in shard
#                   order (JAX's psum; d_out, the contraction of dx, is
#                   what the sharding split)
#   dW^T            shard-local: a shard's weight rows only meet its own
#                   dy panel
#
# Each row's arithmetic is the single-device path's (same stripe content,
# same product shapes), so forward and dW equal it bitwise; dx sums the
# shards' partials, exact to reassociation of the f32 sums (bitwise where
# a shard is whole sections and the product forms each section's partial
# before adding it, as the plain versions do).
@dataclasses.dataclass(frozen=True, eq=False)
class ShardedInCRSLinearMeta:
    """Static metadata of one row-sharded trainable InCRS weight: per-shard
    stripe indices, each on its shard's device (one shape for all shards:
    the slot widths are the densest shard's). ``eq=False``: identity
    hash/eq."""
    fwd_idx: Tuple[torch.Tensor, ...]   # per shard (Op_s, Si, smax) int32
    bwd_idx: Tuple[torch.Tensor, ...]   # per shard (Ip, So_s, smax_t) int32
    t_gather: Tuple[torch.Tensor, ...]  # per shard (Ip*So_s*smax_t,) int32:
    #                                     bwd slot -> shard-local flat fwd
    #                                     slot (one past the end reads 0.0)
    d_in: int
    d_out: int
    section: int
    nnz: int
    mesh: Any
    axes: Tuple[str, ...]     # mesh axes the shard dim is split over
    shard_width: int          # d_out // n_shards output rows per shard
    block: int = B_DEFAULT    # InCRS counter block
    pattern: Any = None       # the SparsityPattern of this meta

    @property
    def n_shards(self) -> int:
        return len(self.fwd_idx)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(t.device for t in self.fwd_idx)


@dataclasses.dataclass
class ShardedInCRSLinearParams:
    values: Tuple[torch.Tensor, ...]    # per shard (Op_s, Si, smax) f32, on
    #                                     its shard's device: trainable
    meta: ShardedInCRSLinearMeta

    @property
    def pattern(self) -> "SparsityPattern | None":
        return self.meta.pattern

    @property
    def d_in(self) -> int:
        return self.meta.d_in

    @property
    def d_out(self) -> int:
        return self.meta.d_out

    @property
    def nnz(self) -> int:
        return self.meta.nnz

    @property
    def density(self) -> float:
        return self.meta.nnz / float(self.meta.d_in * self.meta.d_out)

    @property
    def prep(self) -> ops.ShardedPreparedOperand:
        """The row-sharded W^T operand over the CURRENT values (a view:
        an optimizer step changes what it serves); what a sharded
        ``serve.SpMMEngine`` takes as it is."""
        m = self.meta
        return ops.ShardedPreparedOperand(
            m.fwd_idx, tuple(v.detach() for v in self.values),
            (m.d_out, m.d_in), m.section, m.shard_width, m.mesh, m.axes)


def _resolve_shard_axes(mesh, axis):
    """The mesh and shard-axis spec (for ``ops.shard_axes``): explicit
    arguments win; otherwise the active ``models.sharding`` context gives
    the mesh, and its ``incrs_shard`` rule the axes (else every mesh
    axis)."""
    from ..models import sharding as sh
    if mesh is None:
        mesh = sh.current_mesh()
        if mesh is None:
            raise ValueError(
                "row-sharded InCRSLinear needs a mesh: pass mesh= or "
                "construct inside models.sharding.axis_rules(...)")
    if axis is None and sh.current_mesh() is mesh:
        rule = sh.resolve(sh.INCRS_STRIPE_AXES)[0]
        if rule is not None:
            axis = rule
    return mesh, axis


def _pad_slots_to(a: np.ndarray, width: int, fill) -> np.ndarray:
    return np.pad(a, ((0, 0), (0, 0), (0, width - a.shape[2])),
                  constant_values=fill)


def _sharded_meta(fis, fvs, bis, nnz: int, pat, *, d_in, d_out, section,
                  block, mesh, axes, shard_width
                  ) -> ShardedInCRSLinearParams:
    """Per-shard host stripes -> the params on the shards' devices, the
    meta registered as the pattern's ``incrs_sharded`` packed form."""
    devs = ops.shard_devices(mesh, axes)
    tgs = [_transpose_gather(fis[s], bis[s], section, d_in)
           for s in range(len(devs))]

    def put(arrs):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(d)
                     for a, d in zip(arrs, devs))
    meta = ShardedInCRSLinearMeta(
        put(fis), put(bis), put(tgs), d_in, d_out, section, nnz, mesh, axes,
        shard_width, block=block, pattern=pat)
    pat.packed["incrs_sharded"] = meta
    return ShardedInCRSLinearParams(put(fvs), meta)


def _incrs_sharded_from_dense(
        w: np.ndarray, density: Optional[float] = None, *,
        mask: Optional[np.ndarray] = None, mesh=None, axis=None,
        section: Optional[int] = None, block: Optional[int] = None,
        _pattern: Optional[SparsityPattern] = None
        ) -> ShardedInCRSLinearParams:
    """Pack a dense W (d_in, d_out), optionally magnitude-pruned with the
    same global threshold as the single-device packer, into the
    row-sharded trainable form: one contiguous d_out panel per shard of
    ``mesh`` along ``axis`` (default: the ``incrs_shard`` rule of the
    active sharding context, else every mesh axis). ``mask`` (exclusive
    with ``density``) fixes the pattern explicitly: slots it keeps stay
    live even at value 0.0. ``_pattern`` rides in an evolved pattern."""
    section = S_DEFAULT if section is None else section
    block = B_DEFAULT if block is None else block
    mesh, axis = _resolve_shard_axes(mesh, axis)
    axes, n_shards = ops.shard_axes(mesh, axis)
    w = np.asarray(w, np.float32)
    d_in, d_out = w.shape
    if d_out % n_shards:
        raise ValueError(f"d_out={d_out} must divide into {n_shards} "
                         f"row shards (mesh axes {axes})")
    sw = d_out // n_shards
    pat = _resolve_pattern(w, density, mask, _pattern)
    if pat.shape != (d_in, d_out):
        raise ValueError(f"pattern mask shape {pat.shape} != weight shape "
                         f"{(d_in, d_out)}")
    wt = np.ascontiguousarray(w.T)
    maskt = np.ascontiguousarray(pat.mask.T)
    per = []
    for s in range(n_shards):
        wts = np.ascontiguousarray(wt[s * sw:(s + 1) * sw])
        ms = np.ascontiguousarray(maskt[s * sw:(s + 1) * sw])
        inc = InCRS.from_crs(CRS.from_mask(wts, ms), section=section,
                             block=block)
        inc_t = InCRS.from_crs(
            CRS.from_mask(np.ascontiguousarray(wts.T),
                          np.ascontiguousarray(ms.T)),
            section=section, block=block)
        fi, fv = ops._prep_sections_np(inc, 128)
        bi, _ = ops._prep_sections_np(inc_t, 128)
        per.append((fi, fv, bi, inc.crs.nnz))
    # Stack on a common slot width: the extra slots are -1 / 0.0 pads,
    # which add exactly nothing, so each row's result is the unsharded
    # prep's bit for bit.
    smax = max(p[0].shape[2] for p in per)
    smax_t = max(p[2].shape[2] for p in per)
    return _sharded_meta(
        [_pad_slots_to(p[0], smax, -1) for p in per],
        [_pad_slots_to(p[1], smax, 0.0) for p in per],
        [_pad_slots_to(p[2], smax_t, -1) for p in per],
        sum(p[3] for p in per), pat, d_in=d_in, d_out=d_out,
        section=section, block=block, mesh=mesh, axes=axes, shard_width=sw)


def _incrs_sharded_init(generator: torch.Generator, d_in: int, d_out: int,
                        density: float, scale: float = 0.02,
                        **kw) -> ShardedInCRSLinearParams:
    """Random-normal W (std ``scale``, drawn on the CPU from
    ``generator``), magnitude-pruned to ``density`` and packed
    row-sharded."""
    w = torch.randn((d_in, d_out), generator=generator) * scale
    return _incrs_sharded_from_dense(w.numpy(), density, **kw)


def _incrs_shard(p: InCRSLinearParams, *, mesh=None,
                 axis=None) -> ShardedInCRSLinearParams:
    """Re-shard a trained single-device ``InCRSLinearParams`` across a mesh
    with its values and pattern: the pattern rides along unchanged (same
    lineage uid and version; the sharded pack registers as a second packed
    form of the same snapshot), so a trained value of exactly 0.0 stays a
    trainable slot.

    Where a shard is whole sections (``shard_width % section == 0``) the
    shards are cut from the packed stripes themselves, with no pack from
    the dense weight: a shard's forward rows, its transposed stripes'
    sections and its gather are those of the single-device pack, on the
    same slot widths, so the result is the from-dense pack's bit for
    bit. Otherwise the shard's transposed sections differ, and it packs
    from the dense weight."""
    mesh, axis = _resolve_shard_axes(mesh, axis)
    axes, n_shards = ops.shard_axes(mesh, axis)
    m = p.meta
    sw = m.d_out // n_shards if m.d_out % n_shards == 0 else 0
    if not sw or sw % m.section:
        return _incrs_sharded_from_dense(
            incrs_to_dense_weight(p), mesh=mesh, axis=axis,
            section=m.section, block=m.block, _pattern=p.pattern)
    fwd, vals, bwd = m.fwd_idx, p.values.detach(), m.bwd_idx
    op, si, smax = fwd.shape
    ip, so, smax_t = bwd.shape
    rp = -(-sw // 128) * 128
    so_s = sw // m.section
    fis, fvs, bis, tgs = [], [], [], []
    tg3 = m.t_gather.view(ip, so, smax_t).long()
    for s in range(n_shards):
        lo = s * sw
        fi = fwd.new_full((rp, si, smax), -1)
        fv = vals.new_zeros((rp, si, smax))
        fi[:sw], fv[:sw] = fwd[lo:lo + sw], vals[lo:lo + sw]
        t = tg3[:, s * so_s:(s + 1) * so_s].reshape(-1)
        # a global flat fwd slot -> the shard's: rows shift by lo; the pad
        # slot (fwd.numel()) -> the shard's pad slot
        t = torch.where(t == fwd.numel(), rp * si * smax,
                        t - lo * si * smax)
        fis.append(fi)
        fvs.append(fv)
        bis.append(bwd[:, s * so_s:(s + 1) * so_s].contiguous())
        tgs.append(t.to(torch.int32))
    devs = ops.shard_devices(mesh, axes)

    def put(ts):
        return tuple(t.to(d) for t, d in zip(ts, devs))
    meta = ShardedInCRSLinearMeta(
        put(fis), put(bis), put(tgs), m.d_in, m.d_out, m.section, m.nnz,
        mesh, axes, sw, block=m.block, pattern=p.pattern)
    if p.pattern is not None:
        p.pattern.packed["incrs_sharded"] = meta
    return ShardedInCRSLinearParams(put(fvs), meta)


def _split_rows(t: torch.Tensor, meta: ShardedInCRSLinearMeta):
    """dy^T's or y's shard panels: rows ``[s * sw, (s + 1) * sw)`` of a
    (d_out, T) tensor, each on its shard's device."""
    sw = meta.shard_width
    return [t[s * sw:(s + 1) * sw].to(d) for s, d in
            enumerate(meta.devices)]


def _on_devices(t: torch.Tensor, devices) -> Dict[torch.device, torch.Tensor]:
    """``t`` on each distinct device, copied once a device."""
    return {d: t.to(d) for d in dict.fromkeys(devices)}


class _ShardedInCRSMM(torch.autograd.Function):
    """y[T, d_out] = x[T, d_in] @ W with W^T row-sharded: each shard's
    fused SpMM over its own panel, panels concatenated on d_out."""

    @staticmethod
    def forward(ctx, x, meta, *values):
        ctx.save_for_backward(x, *values)
        ctx.meta = meta
        prep = ops.ShardedPreparedOperand(
            meta.fwd_idx, values, (meta.d_out, meta.d_in), meta.section,
            meta.shard_width, meta.mesh, meta.axes)
        yt = ops.sharded_panels(prep, _on_devices(x.T, meta.devices))
        return torch.cat([t.to(x.device) for t in yt]).T

    @staticmethod
    def backward(ctx, dy):
        x, *values = ctx.saved_tensors
        meta = ctx.meta
        dyt = _split_rows(dy.T, meta)                     # (sw, T) a shard
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _sharded_dx(meta, values, dyt,
                             x.device).T.to(x.dtype)
        dvals = [None] * len(values)
        if any(ctx.needs_input_grad[2:]):
            xs = _on_devices(x, meta.devices)
            dvals = [_stripe_dw(meta.fwd_idx[s], meta.section, xs[d],
                                dyt[s].T).to(values[s].dtype)
                     for s, d in enumerate(meta.devices)]
        return (dx, None, *dvals)


def _sharded_dx(meta: ShardedInCRSLinearMeta, values, dyt,
                home: torch.device) -> torch.Tensor:
    """dx^T[d_in, T] = sum over shards of W_s @ dy_s^T: each shard's fused
    kernel over its transposed stripes (their values gathered by its
    ``t_gather``) and its dy panel ``dyt[s]``, the partials summed on
    ``home`` in shard order, so the sum is the same on every run."""
    dx = None
    for s in range(meta.n_shards):
        flat = torch.cat([values[s].reshape(-1), values[s].new_zeros(1)])
        tvals = flat.index_select(0, meta.t_gather[s]).view(
            meta.bwd_idx[s].shape)
        part = _incrs_product(meta.bwd_idx[s], tvals,
                              (meta.d_in, meta.shard_width), meta.section,
                              dyt[s]).to(home)
        dx = part if dx is None else dx + part
    return dx


def _incrs_sharded_apply(p: ShardedInCRSLinearParams,
                         x: torch.Tensor) -> torch.Tensor:
    """x: (..., d_in) -> (..., d_out) through the per-shard fused kernels;
    differentiable wrt ``p.values`` and ``x``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, p.meta.d_in)
    y = _ShardedInCRSMM.apply(x2, p.meta, *p.values)
    return y.reshape(*lead, p.meta.d_out)


def incrs_sharded_to_dense_weight(p: ShardedInCRSLinearParams
                                  ) -> np.ndarray:
    """Densify W (d_in, d_out) from the CURRENT sharded values (gathered
    to the host)."""
    sw, section = p.meta.shard_width, p.meta.section
    si = p.meta.fwd_idx[0].shape[1]
    wt = np.zeros((p.meta.d_out, si * section), np.float32)
    for s, (idx, vals) in enumerate(zip(p.meta.fwd_idx, p.values)):
        idx, vals = idx.cpu().numpy(), vals.detach().cpu().numpy()
        r, ss, k = np.nonzero(idx >= 0)
        wt[s * sw + r, idx[r, ss, k] + ss * section] = vals[r, ss, k]
    return wt[:, :p.meta.d_in].T


def _sharded_pack_values(meta: ShardedInCRSLinearMeta,
                         w: np.ndarray) -> np.ndarray:
    """Dense W -> (S, Rp, Si, smax) per-shard stripe values of meta's live
    slots (host numpy; ``_sharded_put`` places them)."""
    wt = np.asarray(w, np.float32).T
    sw, section = meta.shard_width, meta.section
    rp, si, smax = meta.fwd_idx[0].shape
    kp = si * section
    vals = np.zeros((meta.n_shards, rp, si, smax), np.float32)
    for s, idx in enumerate(meta.fwd_idx):
        idx = idx.cpu().numpy()
        panel = np.zeros((rp, kp), np.float32)
        rows = wt[s * sw:(s + 1) * sw]
        panel[:rows.shape[0], :rows.shape[1]] = rows
        r, ss, k = np.nonzero(idx >= 0)
        vals[s][r, ss, k] = panel[r, idx[r, ss, k] + ss * section]
    return vals


def _sharded_put(vals: np.ndarray, meta: ShardedInCRSLinearMeta,
                 dtype: Optional[torch.dtype] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """(S, ...) host values -> one tensor a shard on ``meta``'s shard
    devices (in ``dtype``, else their own)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(v)).to(
        device=d, dtype=dtype) for v, d in zip(vals, meta.devices))


# A repack packs on the device of the old node's values.
register_family(SparseLinearParams, FamilyOps(
    "bsr",
    to_dense=lambda n: np.asarray(to_dense(n), np.float32),
    pack=lambda w, pat, like: _bsr_from_mask(
        w, pat.block_mask(like.meta.block), like.meta.block,
        dtype=like.values.dtype, device=like.values.device, _pattern=pat),
    pack_values=_bsr_pack_values,
    default_mask=lambda w, d, n: magnitude_mask(w, d, block=n.meta.block),
    granularity="block"))

register_family(InCRSLinearParams, FamilyOps(
    "incrs",
    to_dense=incrs_to_dense_weight,
    pack=lambda w, pat, like: _pack_incrs(
        w, pat, like.meta.section, like.meta.block,
        device=like.values.device),
    pack_values=_incrs_pack_values,
    default_mask=lambda w, d, n: magnitude_mask(w, d)))

register_family(ShardedInCRSLinearParams, FamilyOps(
    "incrs_sharded",
    to_dense=incrs_sharded_to_dense_weight,
    pack=lambda w, pat, like: _incrs_sharded_from_dense(
        w, mesh=like.meta.mesh, axis=like.meta.axes,
        section=like.meta.section, block=like.meta.block, _pattern=pat),
    pack_values=_sharded_pack_values,
    default_mask=lambda w, d, n: magnitude_mask(w, d),
    put_values=lambda vals, like, dtype: _sharded_put(vals, like.meta,
                                                      dtype)))
