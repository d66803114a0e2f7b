"""One front door: ``SparseSpec`` -> ``plan`` -> execute, for ``incrs``,
``bsr``, ``dense`` and ``crs``.

The port of ``repro.sparse.api``. A ``SparseSpec`` names WHAT the sparse
operand looks like (format x selection x geometry x layout);
``plan`` turns a concrete spec into a ``MatmulPlan`` whose static
metadata is built once; ``MatmulPlan.bind(values)`` gives a ``BoundPlan``,
the self-contained serving operand ``serve.SpMMEngine`` runs wave after
wave: ``bound(B)`` is C = A @ B with A = W^T.

A ``crs`` plan is the sparse x sparse product of the paper's Alg. 2,
plan–execute only: C = A @ B^T for a streamed CRS (or InCRS) B^T. The
plan groups A's non-zeros into per-round rows once (``ai`` and the slot
of each non-zero, ``scatter``); binding scatters the values into that
slot array on the device; a call preps only the right-hand side (memoized
per live object) and runs index matching (``rhs_format`` None or
``"dense"``) or condense + merge (``"crs"``/``"incrs"``).

``Linear`` is the layer face: an ``nn.Module`` whose only ``Parameter``
is ``values``, built by ``Linear.from_dense``/``Linear.init`` under a
spec. Its forward runs the family's forward (the fused InCRS kernel for
``incrs``, the BSR kernel for ``bsr``; ``x @ W`` for ``dense``, as the
JAX package leaves it to XLA), and its backward pass the family's VJP
(``sparse.linear``): ``incrs`` and ``bsr`` layers train.

What binding does once, so that a wave does no host work: the stripe
operand of ``incrs`` (its indices on the values' device), the device
index lists of the BSR kernel (kept on the meta), the values scattered
into the zero-tile-padded slot list, the dense A = W^T made contiguous
on the device, and for ``crs`` the round indices on the device and the
values scattered into their round slots. An ``incrs`` plan reaches only
the fused InCRS kernel, a ``bsr`` plan only the BSR kernel, a ``dense``
plan only the dense kernel and a ``crs`` plan only index matching or
condense + merge.

Tuning: ``plan(spec, rhs_shape, tune="cache"|"measure"|"off")`` attaches
the autotuner's config for the RHS width (``kernels.autotune``) to an
``incrs`` plan, re-proven against ``analysis.launch_check.LAUNCH_RULES``;
its calls and its bound plans launch the tuned order and geometry. A
``Linear``'s forward and backward ride the same cache through
``ops.spmm``'s ``auto``.

Row-sharding: ``SparseSpec("incrs", mesh=, shard_axis=)`` (or
``plan(spec, mesh=)``, or ``Linear.shard(mesh=)`` of a trained layer)
splits W^T's output rows into one stripe panel a shard of a
``launch.mesh.Mesh``; its plans and layers run one fused-kernel launch a
shard, and its backward pass sums dx over the shards.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.bsr import BSR
from ..core.crs import CRS
from ..core.incrs import InCRS
from ..kernels import ops
from . import linear as _lin
from .pattern import (FamilyOps, SparsityPattern, _FAMILIES,
                      expand_block_mask, get_pattern, magnitude_mask,
                      parse_nm, register_family)

FORMATS = ("dense", "bsr", "crs", "incrs")


# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class SparseSpec:
    """WHAT one sparse operand looks like.

    ``format``    one of ``dense`` | ``bsr`` | ``crs`` | ``incrs``, always
                  given.
    selection     at most one of ``density`` (magnitude, one global
                  threshold), ``mask`` (explicit element mask of W — kept
                  slots stay live even at value 0.0), ``pattern`` (an
                  existing ``SparsityPattern``), or a structured ``policy``
                  like ``"2:4"``. Nothing set -> keep the non-zeros.
    geometry      ``section``/``block`` for InCRS stripes (defaults
                  ``core.incrs.S_DEFAULT``/``B_DEFAULT``); ``block`` is the
                  tile side for ``bsr``, ``rounds`` the index-matching
                  window for ``crs``. ``rhs_format`` (crs only) declares
                  the streamed right-hand side sparse too (``"crs"`` or
                  ``"incrs"``): a call then runs condense + merge instead
                  of index matching.
    layout        ``mesh`` (a ``launch.mesh.Mesh``, with an optional
                  ``shard_axis``) row-shards an ``incrs`` operand across
                  that mesh: one contiguous output-row panel a shard. Any
                  other format with a mesh raises.

    ``eq=False`` -> identity hash/eq. Derive variants with
    ``dataclasses.replace``.
    """
    format: str
    density: Optional[float] = None
    mask: Optional[np.ndarray] = None
    pattern: Optional[SparsityPattern] = None
    policy: str = "magnitude"
    section: Optional[int] = None
    block: Optional[int] = None
    rounds: int = 128
    mesh: Any = None
    shard_axis: Any = None
    rhs_format: Optional[str] = None

    def __post_init__(self):
        if self.format not in FORMATS:
            raise ValueError(f"format must be one of {FORMATS}, "
                             f"got {self.format!r}")
        if self.rhs_format is not None:
            if self.rhs_format not in ("dense", "crs", "incrs"):
                raise ValueError(f"rhs_format must be None, 'dense', 'crs' "
                                 f"or 'incrs', got {self.rhs_format!r}")
            if self.rhs_format != "dense" and self.format != "crs":
                raise ValueError(
                    f"a sparse rhs_format ({self.rhs_format!r}) is the "
                    f"SpGEMM path and needs format='crs' (both operands "
                    f"sparse); format {self.format!r} streams a dense RHS")
        n_sel = sum(x is not None
                    for x in (self.density, self.mask, self.pattern))
        if n_sel > 1:
            raise ValueError("pass at most one of density / mask / pattern")
        if self.policy != "magnitude":
            parse_nm(self.policy)               # validate eagerly
            if n_sel:
                raise ValueError(f"policy {self.policy!r} IS the "
                                 f"selection; drop density/mask/pattern")
        if self.mesh is not None and self.format != "incrs":
            raise ValueError(f"mesh sharding is the InCRS data path; "
                             f"format {self.format!r} does not shard")

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    def resolve_pattern(self, w: np.ndarray) -> Optional[SparsityPattern]:
        """The concrete ``SparsityPattern`` this spec selects on weight
        ``w`` (d_in, d_out) — or None for an unmasked dense spec."""
        if self.pattern is not None:
            return self.pattern
        if self.mask is not None:
            return SparsityPattern(np.asarray(self.mask, bool))
        if self.policy != "magnitude":
            return SparsityPattern(
                magnitude_mask(w, None, policy=self.policy))
        if self.density is None and self.format == "dense":
            return None                          # plain dense baseline
        return SparsityPattern(magnitude_mask(
            w, self.density,
            block=self.block if self.format == "bsr" else None))


# ----------------------------------------------------------------------
# Dense "family": the baseline format behind the same node/registry shape
# as the sparse ones; an optional pattern masks the weight.
@dataclasses.dataclass(frozen=True, eq=False)
class DenseLinearMeta:
    d_in: int
    d_out: int
    pattern: Any = None       # optional pattern masking compute


@dataclasses.dataclass
class DenseLinearParams:
    values: torch.Tensor      # (d_in, d_out) dense W
    meta: DenseLinearMeta

    @property
    def pattern(self):
        return self.meta.pattern


def _dense_masked(values: torch.Tensor, meta: DenseLinearMeta):
    if meta.pattern is None:
        return values
    mask = torch.from_numpy(meta.pattern.mask).to(values.device)
    return torch.where(mask, values, torch.zeros((), dtype=values.dtype,
                                                 device=values.device))


def _dense_apply(p: DenseLinearParams, x: torch.Tensor) -> torch.Tensor:
    return x @ _dense_masked(p.values, p.meta).to(x.dtype)


def _dense_to_dense(p: DenseLinearParams) -> np.ndarray:
    w = _dense_masked(p.values, p.meta).detach().cpu()
    if w.dtype == torch.bfloat16:             # numpy has no bfloat16
        w = w.float()
    return np.asarray(w.numpy(), np.float32)


def _make_dense(w, spec: SparseSpec, dtype=torch.float32,
                device=None) -> DenseLinearParams:
    w = np.asarray(w, np.float32)
    pat = spec.resolve_pattern(w)
    if pat is not None and pat.shape != w.shape:
        raise ValueError(f"pattern shape {pat.shape} != weight {w.shape}")
    if pat is not None:
        w = np.where(pat.mask, w, 0.0)
    values = torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(dtype)
    return DenseLinearParams(values.to(ops.resolve_device(device)),
                             DenseLinearMeta(*w.shape, pattern=pat))


def _dense_pack_values(meta: DenseLinearMeta, w) -> np.ndarray:
    w = np.asarray(w, np.float32)
    return np.where(meta.pattern.mask, w, np.float32(0.0)) \
        if meta.pattern is not None else w


def _dense_repack(w, pat: SparsityPattern,
                  like: DenseLinearParams) -> DenseLinearParams:
    meta = DenseLinearMeta(like.meta.d_in, like.meta.d_out, pattern=pat)
    values = torch.from_numpy(np.ascontiguousarray(
        _dense_pack_values(meta, w)))
    return DenseLinearParams(values.to(device=like.values.device,
                                       dtype=like.values.dtype), meta)


register_family(DenseLinearParams, FamilyOps(
    "dense",
    to_dense=_dense_to_dense,
    pack=_dense_repack,
    pack_values=_dense_pack_values,
    default_mask=lambda w, d, n: magnitude_mask(w, d)))


# ----------------------------------------------------------------------
# Index-matching (crs) plan metadata: the fixed sparse operand A is
# round-prepped ONCE; per call only the streamed CRS right-hand side pays
# prep. No trainable layer — plan–execute only.
@dataclasses.dataclass(eq=False)
class CRSPlanMeta:
    ai: torch.Tensor          # (Mp, n_rounds, rmax) int32 round indices
    scatter: torch.Tensor     # (nnz,) int32 flat slots of the val array, in
    #                           A's row-major non-zero order
    shape: Tuple[int, int]    # (M, K) of A
    rounds: int
    pattern: Any = None
    rhs_format: Optional[str] = None   # None/dense -> index matching;
    #                                    "crs"/"incrs" -> condense + merge
    # (id of a live RHS CRS, device) -> (weakref, its round prep): each
    # streamed RHS pays prep once
    _rhs_prep: Dict = dataclasses.field(default_factory=dict, repr=False)
    # device -> (ai, int64 scatter) on it, made once
    _device: Dict = dataclasses.field(default_factory=dict, repr=False)

    def device_index(self, device: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        hit = self._device.get(str(device))
        if hit is None:
            hit = self._device[str(device)] = (
                self.ai.to(device), self.scatter.to(device, torch.int64))
        return hit


_RHS_PREP_MAX = 8


def _rhs_rounds_prep(meta: CRSPlanMeta, b: CRS, device: torch.device):
    """B^T's round prep on ``device``, memoized per live RHS object (a
    weakref guards against a recycled id; at most ``_RHS_PREP_MAX``
    entries, the oldest evicted first)."""
    key = (id(b), str(device))
    hit = meta._rhs_prep.get(key)
    if hit is not None and hit[0]() is b:
        return hit[1]
    prep = ops.prep_rounds(b, meta.rounds, pad_rows_to=128, device=device)
    if len(meta._rhs_prep) >= _RHS_PREP_MAX:
        meta._rhs_prep.pop(next(iter(meta._rhs_prep)))
    meta._rhs_prep[key] = (weakref.ref(b), prep)
    return prep


def _crs_plan_meta(pat: SparsityPattern, rounds: int,
                   rhs_format: Optional[str] = None) -> CRSPlanMeta:
    """A = W^T's round indices, and the flat (row, round, slot) cell of
    each of its non-zeros in row-major order: ``ops.prep_rounds``' slot
    arithmetic (rows padded to 128, rmax = the densest window, at most
    R), on the mask's non-zeros alone."""
    mask_a = pat.mask.T                                # A = W^T (M, K)
    m, k = mask_a.shape
    rows, cols = np.nonzero(mask_a)                    # row-major order
    n_rounds = max(1, -(-k // rounds))
    g = rows.astype(np.int64) * n_rounds + cols // rounds
    counts = np.bincount(g, minlength=m * n_rounds)
    rmax = max(1, min(int(counts.max(initial=1)), rounds))
    group_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    flat = g * rmax + np.arange(g.size, dtype=np.int64) - group_start[g]
    mp = -(-m // 128) * 128
    ai = np.full(mp * n_rounds * rmax, -1, np.int32)
    ai[flat] = cols % rounds
    return CRSPlanMeta(torch.from_numpy(ai.reshape(mp, n_rounds, rmax)),
                       torch.from_numpy(flat.astype(np.int32)), (m, k),
                       rounds, pattern=pat, rhs_format=rhs_format)


def _make_crs(w, spec, dtype=torch.float32, device=None):
    raise ValueError("format 'crs' (both operands sparse) is plan–execute "
                     "only — use sparse.plan / ops.spmm(a_crs, bt_crs); "
                     "there is no trainable crs layer")


def _crs_ready(meta: CRSPlanMeta, values: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ai, av) on the values' device: the values scattered into their
    round slots by one device ``index_put``."""
    if tuple(values.shape) != tuple(meta.scatter.shape):
        raise ValueError(f"a crs plan binds one value per slot of its "
                         f"pattern, {meta.scatter.numel()}; got values of "
                         f"shape {tuple(values.shape)}")
    ai, scatter = meta.device_index(values.device)
    av = torch.zeros(ai.numel(), dtype=torch.float32, device=values.device)
    av[scatter] = values.detach().to(torch.float32)
    return ai, av.view(ai.shape)


def _crs_call(meta: CRSPlanMeta, ready, b, variant: str = "auto"
              ) -> torch.Tensor:
    """C = A @ B^T for a CRS (or InCRS) B^T: index matching, or condense +
    merge when the plan declares a sparse ``rhs_format``; ``variant=
    "reference"`` forces index matching. C is (M, N) in the promoted type
    of the two value tensors."""
    if variant not in ("auto", "reference"):
        raise ValueError(f"a crs plan's variant is 'auto' or 'reference', "
                         f"got {variant!r}")
    if isinstance(b, InCRS):
        b = b.crs
    if not isinstance(b, CRS):
        raise TypeError("a 'crs' plan runs sparse x sparse C = A @ B^T "
                        "and needs B^T as a CRS (or InCRS)")
    if b.shape[1] != meta.shape[1]:
        raise ValueError(f"inner dims disagree: A is {meta.shape}, "
                         f"Bt is {b.shape} (expected equal col counts)")
    ai, av = ready
    bi, bv = _rhs_rounds_prep(meta, b, ai.device)
    if meta.rhs_format in ("crs", "incrs") and variant != "reference":
        from .. import spgemm as _spgemm       # circular at module scope
        out = _spgemm.condense_merge_prepped(ai, av, bi, bv,
                                             rounds=meta.rounds)
    else:
        out = ops.index_match_prepped(ai, av, bi, bv, rounds=meta.rounds)
    return out[:meta.shape[0], :b.shape[0]]


def _crs_pack(meta: CRSPlanMeta, w) -> np.ndarray:
    """Dense W (d_in, d_out) -> A = W^T's values at the pattern's slots,
    in row-major order."""
    a = np.asarray(w, np.float32).T
    return np.ascontiguousarray(a[meta.pattern.mask.T])


# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FormatAdapter:
    """Everything one format plugs into the front door: construction from
    a dense weight, layer apply, plan execution, and spec recovery."""
    name: str
    make: Callable                     # (w, spec, dtype, device) -> params
    apply: Optional[Callable]          # (params, x) -> y; None: no layer
    call: Callable                     # (meta, ready, b[, variant]) -> C
    pack: Callable                     # (meta, w) -> plan values (numpy)
    spec_of: Callable                  # (meta) -> SparseSpec
    plan_values: Callable = lambda inner: inner.values  # layer -> plan vals
    # (meta, values) -> what ``call`` executes with: the device-ready form
    # a BoundPlan builds once, at bind
    ready: Callable = lambda meta, values: values
    # whether ``call`` takes a ``variant=`` (crs: "auto" or "reference")
    takes_variant: bool = False
    # (meta, host array, device) -> plan values where ``bind`` puts them
    put: Callable = lambda meta, values, device: torch.from_numpy(
        np.ascontiguousarray(values)).to(ops.resolve_device(device))


_ADAPTERS: Dict[Tuple[str, bool], FormatAdapter] = {}
_BY_CLS: Dict[type, FormatAdapter] = {}


def register_format(fmt: str, params_cls: Optional[type],
                    adapter: FormatAdapter, *, sharded: bool = False
                    ) -> None:
    """The spec registry: consumers (Linear, plans, engines) discover
    each (format, sharded?) family here instead of per-family isinstance
    chains."""
    _ADAPTERS[(fmt, sharded)] = adapter
    if params_cls is not None:
        _BY_CLS[params_cls] = adapter


def _adapter(spec: SparseSpec) -> FormatAdapter:
    ad = _ADAPTERS.get((spec.format, spec.sharded))
    if ad is None:
        raise ValueError(f"no kernel family serves format {spec.format!r} "
                         f"(sharded={spec.sharded})")
    return ad


def _execute(spec: SparseSpec, meta, ready, b, variant: Optional[str],
             tuned=None):
    """One call of a plan over its device-ready values; only a format
    whose ``call`` takes a variant accepts one. ``tuned`` (an ``incrs``
    plan's config) runs where no variant is given."""
    ad = _adapter(spec)
    if variant is None:
        if tuned is not None:
            return ad.call(meta, ready, b, tuned=tuned)
        return ad.call(meta, ready, b)
    if not ad.takes_variant:
        raise ValueError(f"a {spec.format!r} plan runs one kernel and "
                         f"takes no variant, got {variant!r}")
    return ad.call(meta, ready, b, variant=variant)


def adapter_of(node: Any) -> FormatAdapter:
    """Registry lookup for a params node (Linear or raw family)."""
    if isinstance(node, Linear):
        node = node.inner
    ad = _BY_CLS.get(type(node))
    if ad is None:
        raise TypeError(f"{type(node).__name__} is not a registered "
                        f"sparse-linear family")
    return ad


# ---- per-format constructors ------------------------------------------
def _make_bsr(w, spec: SparseSpec, dtype=torch.float32, device=None):
    """BSR stores WHOLE tiles: an element selection is widened to the
    blocks it touches, and the minted pattern records that block-expanded
    mask (so ``pattern``/``nnz``/``to_dense`` agree with what the kernel
    computes). An explicit ``pattern`` must already be block-aligned."""
    if spec.block is None:
        raise ValueError("format 'bsr' needs block= (the square tile side)")
    if spec.policy != "magnitude":
        raise ValueError("n:m selection is element-level; 'bsr' prunes "
                         "whole blocks — use format 'incrs' or "
                         "policy='magnitude'")
    w = np.asarray(w, np.float32)
    pat = spec.resolve_pattern(w)
    if pat is None:                       # keep non-zero blocks
        pat = SparsityPattern(magnitude_mask(w, None, block=spec.block))
    block_mask = pat.block_mask(spec.block)
    expanded = expand_block_mask(block_mask, spec.block)
    if spec.pattern is not None:
        if not np.array_equal(expanded, pat.mask):
            raise ValueError(
                "format 'bsr' keeps whole tiles: the pattern must be "
                "block-aligned (pass the block-expanded mask, or use mask= "
                "to let the packer widen it)")
    elif not np.array_equal(expanded, pat.mask):
        pat = SparsityPattern(expanded)   # widen an element mask to tiles
    return _lin._bsr_from_mask(w, block_mask, spec.block, dtype=dtype,
                               device=device, _pattern=pat)


def _make_incrs(w, spec: SparseSpec, dtype=torch.float32, device=None):
    """The InCRS family packs f32 stripe values (the fused kernel sums in
    f32): another dtype raises instead of coming back as f32."""
    if dtype != torch.float32:
        raise ValueError(f"format 'incrs' stores f32 stripe values (the "
                         f"fused kernel's accumulation dtype); "
                         f"dtype={dtype} is not supported")
    kw = dict(section=spec.section, block=spec.block, device=device)
    if spec.policy != "magnitude":
        return _lin._incrs_from_dense(
            w, mask=magnitude_mask(w, None, policy=spec.policy), **kw)
    return _lin._incrs_from_dense(w, density=spec.density, mask=spec.mask,
                                  _pattern=spec.pattern, **kw)


def _make_incrs_sharded(w, spec: SparseSpec, dtype=torch.float32,
                        device=None):
    """The row-sharded InCRS family: each shard's values go to its device
    of the spec's mesh, so ``device`` is not used."""
    if dtype != torch.float32:
        raise ValueError(f"format 'incrs' stores f32 stripe values (the "
                         f"fused kernel's accumulation dtype); "
                         f"dtype={dtype} is not supported")
    kw = dict(mesh=spec.mesh, axis=spec.shard_axis, section=spec.section,
              block=spec.block)
    if spec.policy != "magnitude":
        return _lin._incrs_sharded_from_dense(
            w, mask=magnitude_mask(w, None, policy=spec.policy), **kw)
    return _lin._incrs_sharded_from_dense(
        w, density=spec.density, mask=spec.mask, _pattern=spec.pattern, **kw)


# ---- per-format plan execution ----------------------------------------
def _incrs_call(meta, prep: ops.PreparedOperand, b,
                tuned=None) -> torch.Tensor:
    return ops.spmm(prep, torch.as_tensor(b), tuned=tuned)


def _incrs_ready(meta, values: torch.Tensor) -> ops.PreparedOperand:
    """The stripe operand over ``values``, its indices on their device."""
    return ops.PreparedOperand(meta.fwd_idx.to(values.device),
                               values.detach().contiguous(),
                               (meta.d_out, meta.d_in), meta.section)


def _incrs_sharded_call(meta, prep: ops.ShardedPreparedOperand, b,
                        tuned=None) -> torch.Tensor:
    """C = A @ B, one launch a shard; a tuned config's order and geometry
    apply to every shard's panel (they share one shape)."""
    return ops.spmm(prep, torch.as_tensor(b), tuned=tuned)


def _incrs_sharded_ready(meta, values) -> ops.ShardedPreparedOperand:
    """The sharded stripe operand over ``values``, one tensor a shard on
    its shard's device."""
    if len(values) != meta.n_shards:
        raise ValueError(f"a sharded plan binds one values tensor a "
                         f"shard, {meta.n_shards}; got {len(values)}")
    return ops.ShardedPreparedOperand(
        meta.fwd_idx, tuple(v.detach().contiguous() for v in values),
        (meta.d_out, meta.d_in), meta.section, meta.shard_width, meta.mesh,
        meta.axes)


def _dense_call(meta, a: torch.Tensor, b) -> torch.Tensor:
    return ops.spmm(a, torch.as_tensor(b), device=a.device)


def _dense_ready(meta, a: torch.Tensor) -> torch.Tensor:
    return a.detach().contiguous()


def _bsr_call(meta, slots: torch.Tensor, b) -> torch.Tensor:
    return _lin._bsr_forward(meta, slots, torch.as_tensor(b).to(slots.device))


def _bsr_ready(meta, values: torch.Tensor) -> torch.Tensor:
    meta.kernel_index(values.device)              # device lists, once
    return _lin._pad_slots(values.detach(), meta)


def _dense_pack(meta, w) -> np.ndarray:
    """Dense W (d_in, d_out) -> plan values A = W^T (pattern-masked) —
    the same A-orientation every other adapter's pack returns."""
    w = np.asarray(w, np.float32)
    if meta is not None and meta.pattern is not None:
        w = np.where(meta.pattern.mask, w, 0.0)
    return np.ascontiguousarray(w.T)


register_format("dense", DenseLinearParams, FormatAdapter(
    "dense",
    make=_make_dense, apply=_dense_apply, call=_dense_call,
    pack=_dense_pack,
    spec_of=lambda meta: SparseSpec("dense", pattern=meta.pattern),
    plan_values=lambda inner: _dense_masked(inner.values, inner.meta).T,
    ready=_dense_ready))

register_format("incrs", _lin.InCRSLinearParams, FormatAdapter(
    "incrs",
    make=_make_incrs, apply=_lin._incrs_apply, call=_incrs_call,
    pack=lambda meta, w: _lin._incrs_pack_values(meta, w),
    spec_of=lambda meta: SparseSpec("incrs", section=meta.section,
                                    block=meta.block, pattern=meta.pattern),
    ready=_incrs_ready))

register_format("incrs", _lin.ShardedInCRSLinearParams, FormatAdapter(
    "incrs_sharded",
    make=_make_incrs_sharded, apply=_lin._incrs_sharded_apply,
    call=_incrs_sharded_call,
    pack=lambda meta, w: _lin._sharded_pack_values(meta, w),
    spec_of=lambda meta: SparseSpec("incrs", section=meta.section,
                                    block=meta.block, pattern=meta.pattern,
                                    mesh=meta.mesh, shard_axis=meta.axes),
    plan_values=lambda inner: tuple(inner.values),
    ready=_incrs_sharded_ready,
    put=lambda meta, values, device: _lin._sharded_put(values, meta)),
    sharded=True)

register_format("bsr", _lin.SparseLinearParams, FormatAdapter(
    "bsr",
    make=_make_bsr, apply=_lin._bsr_apply, call=_bsr_call,
    pack=lambda meta, w: _lin._bsr_pack_values(meta, w),
    spec_of=lambda meta: SparseSpec("bsr", block=meta.block,
                                    pattern=meta.pattern),
    ready=_bsr_ready))

register_format("crs", None, FormatAdapter(
    "crs",
    make=_make_crs, apply=None, call=_crs_call, pack=_crs_pack,
    spec_of=lambda meta: SparseSpec("crs", rounds=meta.rounds,
                                    pattern=meta.pattern,
                                    rhs_format=meta.rhs_format),
    ready=_crs_ready, takes_variant=True))


# ----------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class MatmulPlan:
    """The execute half of plan–execute: static kernel metadata built once
    from a concrete spec; ``plan(values, B)`` runs C = A @ B (A = W^T, the
    kernel orientation). ``pack`` turns a dense W (d_in, d_out) into the
    plan's packed values; ``bind`` closes over one values tensor.

    ``tuned`` is an optional ``kernels.autotune.TunedConfig`` (attached by
    ``plan(..., tune=...)`` or ``MatmulPlan.tune``): every call then
    launches the tuned order, and at the width it was measured at its
    launch geometry, with no cache lookup or model evaluation. An explicit
    ``variant=`` at call time overrides it."""
    spec: SparseSpec
    meta: Any                 # family meta; CRSPlanMeta; None for dense
    tuned: Any = None         # kernels.autotune.TunedConfig

    def __call__(self, values, b, *, variant: Optional[str] = None):
        """C = A @ B for ``values`` on their device (crs: C = A @ B^T for
        a CRS B^T; ``variant="reference"`` forces index matching)."""
        ready = _adapter(self.spec).ready(self.meta, values)
        return _execute(self.spec, self.meta, ready, b, variant, self.tuned)

    # -- kernel tuning --------------------------------------------------
    def _tuning_arrays(self) -> Optional[Tuple[torch.Tensor, int]]:
        """(idx, section) of the InCRS stripes this plan launches with (a
        sharded plan's: one shard's panel, the shape every shard
        launches), or None for a format without them."""
        if self.spec.format != "incrs" or self.meta is None:
            return None
        idx = self.meta.fwd_idx
        return (idx if isinstance(idx, torch.Tensor) else idx[0]), \
            self.meta.section

    def _key(self, n_cols: int, device) -> Optional[str]:
        from ..kernels import autotune
        arrs = self._tuning_arrays()
        if arrs is None:
            return None
        idx, section = arrs
        backend = autotune.default_backend() if device is None else \
            autotune.backend_name(ops.resolve_device(device))
        return autotune.cache_key(idx.shape[0], idx.shape[1], idx.shape[2],
                                  section, int(n_cols), backend)

    def lookup_tuned(self, n_cols: int, *, device=None):
        """The tuning cache's config for an ``n_cols``-wide RHS on
        ``device`` (default: the current CUDA device, else the CPU's
        entries), if one exists; never measures."""
        from ..kernels import autotune
        key = self._key(n_cols, device)
        return None if key is None else autotune.lookup(key)

    def tune(self, n_cols: int, *, device=None, reps: int = 10,
             persist: bool = True, top_k=None) -> "MatmulPlan":
        """Sweep this plan's kernel for an ``n_cols``-wide RHS on
        ``device`` (default CUDA) and return a plan carrying the winner
        (persisted unless ``persist=False``). Values do not change which
        slots a launch reads, so the sweep runs on zeros. ``top_k``
        measures only the cost model's first candidates."""
        from ..kernels import autotune
        arrs = self._tuning_arrays()
        if arrs is None:
            raise ValueError(f"format {self.spec.format!r} has no tunable "
                             f"fused kernel")
        idx, section = arrs
        dev = ops.resolve_device(device)
        idx = idx.to(dev)
        kw = {} if top_k is None else {"top_k": top_k}
        cfg = autotune.tune(
            idx, torch.zeros(idx.shape, dtype=torch.float32, device=dev),
            torch.zeros((idx.shape[1] * section, int(n_cols)),
                        dtype=torch.float32, device=dev),
            section=section, reps=reps, persist=persist, **kw)
        return dataclasses.replace(self, tuned=cfg)

    def check_feasible(self, n_cols: int, *, device=None) -> None:
        """Prove this plan's tuned launch against
        ``analysis.launch_check.LAUNCH_RULES`` for an ``n_cols``-wide RHS
        (its geometry where it was measured at that width, else its
        order's own geometry there). Raises ``KernelConfigError`` (a
        ValueError) naming the rule; a no-op for an untuned plan or a
        format without stripes."""
        from ..analysis import launch_check
        from ..kernels import incrs_spmm
        cfg, arrs = self.tuned, self._tuning_arrays()
        if cfg is None or arrs is None:
            return
        idx, section = arrs
        n_cols = int(n_cols)
        on_card = device is not None and \
            ops.resolve_device(device).type == "cuda"
        launch_check.require_feasible(
            cfg.variant,
            m=incrs_spmm._resolve_row_tile(idx.shape[0], cfg.bm)[1],
            n=-(-n_cols // cfg.bn) * cfg.bn, n_sections=idx.shape[1],
            smax=idx.shape[2], section=section,
            geometry=cfg.launch_geometry if cfg.n_cols == n_cols else None,
            on_card=on_card,
            context=f"plan tuned config ({cfg.variant}, "
                    f"{cfg.geometry}) at {n_cols} columns")

    def pack(self, w) -> np.ndarray:
        """Dense W (d_in, d_out) -> packed plan values (for 'dense' the
        A = W^T array itself, pattern-masked)."""
        return _adapter(self.spec).pack(self.meta, w)

    def bind(self, values, *, device=None) -> "BoundPlan":
        """A ``BoundPlan`` over ``values``: a tensor (a sharded plan: one a
        shard), kept where it is, or an array, moved to ``device``
        (default CUDA; a sharded plan's shards go to their mesh
        devices)."""
        if isinstance(values, (list, tuple)):
            values = tuple(values)
        elif not isinstance(values, torch.Tensor):
            values = _adapter(self.spec).put(self.meta, values, device)
        return BoundPlan(self, values)

    @property
    def pattern(self) -> Optional[SparsityPattern]:
        if self.meta is not None and \
                getattr(self.meta, "pattern", None) is not None:
            return self.meta.pattern
        return self.spec.pattern

    @property
    def shape(self) -> Optional[Tuple[int, int]]:
        """(M, K) of the sparse operand A = W^T; None for an unpatterned
        dense plan (the bound values carry the shape)."""
        if isinstance(self.meta, CRSPlanMeta):
            return self.meta.shape
        if self.meta is not None and hasattr(self.meta, "d_out"):
            return (self.meta.d_out, self.meta.d_in)
        pat = self.pattern
        return (pat.d_out, pat.d_in) if pat is not None else None


@dataclasses.dataclass(eq=False)
class BoundPlan:
    """A ``MatmulPlan`` closed over one values tensor — a self-contained
    serving operand: ``bound(B)`` executes, ``.shape``/``.pattern`` are
    what engines validate and version against. The device-ready form of
    the values is built here, once."""
    plan: MatmulPlan
    values: torch.Tensor
    _ready: Any = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self._ready = _adapter(self.plan.spec).ready(self.plan.meta,
                                                     self.values)

    def __call__(self, b, *, variant: Optional[str] = None
                 ) -> torch.Tensor:
        return _execute(self.plan.spec, self.plan.meta, self._ready, b,
                        variant, self.plan.tuned)

    @property
    def shape(self) -> Tuple[int, int]:
        s = self.plan.shape
        return tuple(self.values.shape) if s is None else s

    @property
    def pattern(self) -> Optional[SparsityPattern]:
        return self.plan.pattern

    @property
    def device(self) -> torch.device:
        """Where a call's C lands: the values' device (a sharded plan's:
        its first shard's)."""
        v = self.values
        return (v if isinstance(v, torch.Tensor) else v[0]).device


def plan(spec: SparseSpec, rhs_shape: Optional[Tuple[int, ...]] = None,
         *, mesh=None, tune: str = "cache", device=None) -> MatmulPlan:
    """Build the static half of C = A @ B for ``spec`` — prep once,
    execute many.

    The spec must pin the operand concretely: a ``pattern`` or ``mask``
    for ``bsr`` (a density-only spec needs values to select on — use
    ``Linear.from_dense`` or ``plan_for_operand``), nothing for plain
    ``dense``. ``rhs_shape``, when given, is validated against the
    operand's K. ``mesh`` sets (or replaces) the spec's mesh: a row-sharded
    ``incrs`` plan.

    ``tune`` decides the launch of an ``incrs`` plan where ``rhs_shape``
    pins the RHS width: ``"cache"`` (default) attaches the tuning cache's
    entry for that width on ``device`` if there is one; ``"measure"``
    sweeps now on ``device`` (default CUDA; a cache hit included) and
    attaches the winner; ``"off"`` attaches nothing (calls then take
    ``auto``). An attached config is re-proven against the launch rules
    here, so a stale entry raises at plan time, not at launch.
    """
    if tune not in ("cache", "measure", "off"):
        raise ValueError(f"tune must be 'cache', 'measure' or 'off', "
                         f"got {tune!r}")
    if mesh is not None:
        spec = dataclasses.replace(spec, mesh=mesh)
    _adapter(spec)
    if spec.format == "dense" and spec.pattern is None and \
            spec.mask is None:
        return MatmulPlan(spec, None)
    pat = spec.pattern if spec.pattern is not None else (
        SparsityPattern(np.asarray(spec.mask, bool))
        if spec.mask is not None else None)
    if pat is None:
        raise ValueError(
            "plan() needs a concrete pattern (pattern= or mask= on the "
            "spec) — a density/policy selection depends on values; use "
            "Linear.from_dense(w, spec) or plan_for_operand(a, spec)")
    if rhs_shape is not None and rhs_shape and rhs_shape[0] != pat.d_in:
        raise ValueError(f"rhs_shape {tuple(rhs_shape)} does not contract "
                         f"with K={pat.d_in}")
    spec = dataclasses.replace(spec, density=None, mask=None, pattern=pat,
                               policy="magnitude")
    if spec.format == "crs":
        return MatmulPlan(spec, _crs_plan_meta(pat, spec.rounds,
                                               rhs_format=spec.rhs_format))
    inner = _adapter(spec).make(np.zeros(pat.shape, np.float32), spec,
                                device="cpu")
    built = MatmulPlan(spec, inner.meta)
    if spec.format == "incrs" and rhs_shape is not None and \
            len(rhs_shape) >= 2 and tune != "off":
        n_cols = int(rhs_shape[1])
        if tune == "measure":
            built = built.tune(n_cols, device=device)
        else:
            built = dataclasses.replace(
                built, tuned=built.lookup_tuned(n_cols, device=device))
        built.check_feasible(n_cols, device=device)
    return built


def plan_for_operand(a, spec: SparseSpec, *, device=None) -> BoundPlan:
    """Spec-drive a CONCRETE operand A (M, K) into a bound, servable plan
    on ``device`` (default CUDA): ``plan_for_operand(a, spec)(B)`` is
    C = A @ B.

    ``a`` may be a dense array or tensor, ``CRS``, ``InCRS`` or ``BSR``;
    its transpose is the weight the spec selects on (no selection set ->
    the operand's own non-zeros, i.e. serve A exactly as given). This is
    the one-liner the serving launcher uses for ``--format bsr|dense``.
    """
    _adapter(spec)
    if isinstance(a, InCRS):
        a = a.crs
    if isinstance(a, (CRS, BSR)):
        a = a.to_dense()
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a, np.float32)
    if a.ndim != 2:
        raise ValueError(f"operand must be 2-D, got shape {a.shape}")
    w = np.ascontiguousarray(a.T)                      # W = A^T
    if spec.format != "dense" and spec.density is None and \
            spec.mask is None and spec.pattern is None and \
            spec.policy == "magnitude":
        spec = dataclasses.replace(spec, mask=np.ascontiguousarray(a != 0).T)
    if spec.format == "crs":                   # plan–execute only
        p = plan(dataclasses.replace(spec, density=None, mask=None,
                                     pattern=spec.resolve_pattern(w),
                                     policy="magnitude"))
        return p.bind(p.pack(w), device=device)
    lin = Linear.from_dense(w, spec, device=device)
    # the layer is dropped here, so its values need no copy (``bound()``)
    return BoundPlan(lin.plan, _detached(adapter_of(lin.inner).plan_values(
        lin.inner)))


# ----------------------------------------------------------------------
class Linear(torch.nn.Module):
    """ONE sparse/dense linear layer: y = x @ W behind a spec.

    ``values`` is the only ``Parameter`` (a row-sharded layer's: a
    ``ParameterList``, one a shard, on its shard's device); ``meta`` is
    the format's static metadata (the pattern rides on it). ``inner`` is
    the format's params node over the same tensors, what the registry
    dispatches on.
    """

    def __init__(self, inner):
        super().__init__()
        self._cls = type(inner)
        adapter_of(inner)                       # a registered format
        self.values = _as_parameters(inner.values)
        self.meta = inner.meta

    # -- one constructor family ---------------------------------------
    @classmethod
    def init(cls, d_in: int, d_out: int, spec: SparseSpec, *,
             generator: torch.Generator, scale: float = 0.02,
             dtype=torch.float32, device=None) -> "Linear":
        """Random-normal init (std ``scale``, drawn on the CPU from
        ``generator``) packed under ``spec``."""
        w = torch.randn((d_in, d_out), generator=generator) * scale
        return cls.from_dense(w.numpy(), spec, dtype=dtype, device=device)

    @classmethod
    def from_dense(cls, w, spec: SparseSpec, *, dtype=torch.float32,
                   device=None) -> "Linear":
        """Pack a dense W (d_in, d_out) under ``spec`` on ``device``
        (default CUDA) — the spec's selection (density / mask / pattern)
        decides which slots stay live."""
        if isinstance(w, torch.Tensor):
            w = w.detach().cpu().numpy()
        return cls(_adapter(spec).make(np.asarray(w, np.float32), spec,
                                       dtype=dtype, device=device))

    def set_inner(self, inner) -> None:
        """Take ``inner`` (a node of the same family, e.g. a repack of
        this layer's) as the layer: its meta and a new ``values``
        ``Parameter`` under the same name."""
        if type(inner) is not self._cls:
            raise TypeError(f"a {self._cls.__name__} layer cannot take a "
                            f"{type(inner).__name__}")
        self.values = _as_parameters(inner.values)
        self.meta = inner.meta

    def shard(self, mesh=None, axis=None) -> "Linear":
        """Re-shard this trained single-device ``incrs`` layer across a
        mesh, values and pattern lineage kept (train on one device, serve
        or train on); ``mesh``/``axis`` default as the sharded packer's
        (``sparse.linear._resolve_shard_axes``)."""
        if not isinstance(self.inner, _lin.InCRSLinearParams):
            raise ValueError(f"shard() re-shards the single-device InCRS "
                             f"family; this layer is {self.format!r}")
        return Linear(_lin._incrs_shard(self.inner, mesh=mesh, axis=axis))

    # -- one apply ------------------------------------------------------
    def forward(self, x):
        return apply(self, x)

    # -- views ----------------------------------------------------------
    @property
    def inner(self):
        v = self.values
        return self._cls(v if isinstance(v, torch.Tensor) else tuple(v),
                         self.meta)

    @property
    def pattern(self) -> Optional[SparsityPattern]:
        return get_pattern(self.inner)

    @property
    def spec(self) -> SparseSpec:
        return adapter_of(self.inner).spec_of(self.meta)

    @property
    def format(self) -> str:
        return adapter_of(self.inner).name

    @property
    def d_in(self) -> int:
        return self.meta.d_in

    @property
    def d_out(self) -> int:
        return self.meta.d_out

    @property
    def nnz(self) -> int:
        pat = self.pattern
        return pat.nnz if pat is not None else self.d_in * self.d_out

    @property
    def density(self) -> float:
        return self.nnz / float(self.d_in * self.d_out)

    @property
    def plan(self) -> MatmulPlan:
        return MatmulPlan(self.spec, self.meta)

    def bound(self) -> BoundPlan:
        """Servable C = A @ B over a copy of the CURRENT values (A = W^T),
        detached from autograd: an optimizer step on the layer does not
        change what the bound plan serves (swap a new ``bound()`` into an
        engine to deploy it)."""
        return BoundPlan(self.plan, _detached(
            adapter_of(self.inner).plan_values(self.inner), clone=True))

    def to_dense(self, values: Optional[torch.Tensor] = None
                 ) -> np.ndarray:
        """Densify W (d_in, d_out) from the current values, or from
        ``values`` laid out like them (their gradient, say; one a shard
        for a row-sharded layer)."""
        if isinstance(values, list):
            values = tuple(values)
        node = self.inner if values is None else self._cls(values,
                                                           self.meta)
        return _FAMILIES[self._cls].to_dense(node)


def _detached(values, clone: bool = False):
    """Plan values out of autograd (copied with ``clone``): one tensor, or
    a tuple of one a shard."""
    def one(v):
        v = v.detach()
        return v.clone() if clone else v
    if isinstance(values, torch.Tensor):
        return one(values)
    return tuple(one(v) for v in values)


def _as_parameters(values):
    """A family's values as the layer's trainable leaf: one ``Parameter``,
    or a ``ParameterList`` of one a shard."""
    if isinstance(values, torch.Tensor):
        return torch.nn.Parameter(values.detach(), requires_grad=True)
    return torch.nn.ParameterList(
        torch.nn.Parameter(v.detach(), requires_grad=True) for v in values)


def apply(p, x):
    """THE layer apply: dispatches any ``Linear`` (or raw family params
    node — pipeline stages slice those out of stacks) through its
    family's forward."""
    node = p.inner if isinstance(p, Linear) else p
    return adapter_of(node).apply(node, x)


def stack_init(n_stages: int, d_in: int, d_out: int, spec: SparseSpec, *,
               generator: torch.Generator, scale: float = 0.02,
               device=None) -> Linear:
    """Shared-pattern parameter stack for pipeline stages: ONE sparsity
    pattern (a single meta serves every stage), per-stage values stacked
    along a leading stage axis, on ``device`` (default CUDA). InCRS
    format only — see ``train.pipeline``. The stacked node is not
    repackable (``pattern.is_stacked_node``); the prune callback warns
    and skips it. Apply a stage through ``train.pipeline``, which slices
    it out."""
    if spec.format != "incrs" or spec.sharded:
        raise ValueError("stack_init stacks the single-device InCRS "
                         "family (pipeline stages)")
    if spec.density is None:
        raise ValueError("stack_init needs density= on the spec")
    return Linear(_lin._incrs_stack_init(
        generator, n_stages, d_in, d_out, spec.density, scale,
        section=spec.section, block=spec.block, device=device))


__all__ = [
    "FORMATS", "SparseSpec", "MatmulPlan", "BoundPlan", "Linear",
    "CRSPlanMeta",
    "DenseLinearParams", "DenseLinearMeta", "FormatAdapter",
    "register_format", "adapter_of", "plan", "plan_for_operand", "apply",
    "stack_init",
]
