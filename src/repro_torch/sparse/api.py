"""One front door: ``SparseSpec`` -> ``plan`` -> execute, for ``incrs``,
``bsr`` and ``dense``.

The port of ``repro.sparse.api``, single-device. A ``SparseSpec`` names
WHAT the sparse operand looks like (format x selection x geometry);
``plan`` turns a concrete spec into a ``MatmulPlan`` whose static
metadata is built once; ``MatmulPlan.bind(values)`` gives a ``BoundPlan``,
the self-contained serving operand ``serve.SpMMEngine`` runs wave after
wave: ``bound(B)`` is C = A @ B with A = W^T.

``Linear`` is the layer face: an ``nn.Module`` whose only ``Parameter``
is ``values``, built by ``Linear.from_dense``/``Linear.init`` under a
spec. Its forward runs the family's forward (the fused InCRS kernel for
``incrs``, the BSR kernel for ``bsr``; ``x @ W`` for ``dense``, as the
JAX package leaves it to XLA), and its backward pass the family's VJP
(``sparse.linear``): ``incrs`` and ``bsr`` layers train.

What binding does once, so that a wave does no host work: the stripe
operand of ``incrs`` (its indices on the values' device), the device
index lists of the BSR kernel (kept on the meta), the values scattered
into the zero-tile-padded slot list, and the dense A = W^T made
contiguous on the device. An ``incrs`` plan reaches only the fused InCRS
kernel, a ``bsr`` plan only the BSR kernel and a ``dense`` plan only the
dense kernel.

Not ported yet: the ``crs`` format in ``plan`` (ROADMAP queue 1 item
5), row-sharding (``mesh``, item 8), the TPU tuning members of
``MatmulPlan`` (items 9-10) and the lifecycle (``repack``, item 5).
"""
from __future__ import annotations

import dataclasses
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

_NOT_PORTED = {
    "crs": "the crs plan (CRSPlanMeta and the rhs_format route) is not "
           "ported yet (ROADMAP queue 1 item 5, its open part); run "
           "ops.spmm(a_crs, bt_crs) or spgemm.spgemm",
}


# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class SparseSpec:
    """WHAT one sparse operand looks like.

    ``format``    one of ``dense`` | ``bsr`` | ``crs`` | ``incrs``, always
                  given (``crs`` does not plan in the port yet: it
                  raises).
    selection     at most one of ``density`` (magnitude, one global
                  threshold), ``mask`` (explicit element mask of W — kept
                  slots stay live even at value 0.0), ``pattern`` (an
                  existing ``SparsityPattern``), or a structured ``policy``
                  like ``"2:4"``. Nothing set -> keep the non-zeros.
    geometry      ``section``/``block`` for InCRS stripes (defaults
                  ``core.incrs.S_DEFAULT``/``B_DEFAULT``); ``block`` is the
                  tile side for ``bsr``. The crs geometry (``rounds``,
                  ``rhs_format``) comes with that format's plan.
    ``mesh``      row-sharding is not ported: setting it raises.

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
    mesh: Any = None

    def __post_init__(self):
        if self.format not in FORMATS:
            raise ValueError(f"format must be one of {FORMATS}, "
                             f"got {self.format!r}")
        n_sel = sum(x is not None
                    for x in (self.density, self.mask, self.pattern))
        if n_sel > 1:
            raise ValueError("pass at most one of density / mask / pattern")
        if self.policy != "magnitude":
            parse_nm(self.policy)               # validate eagerly
            if n_sel:
                raise ValueError(f"policy {self.policy!r} IS the "
                                 f"selection; drop density/mask/pattern")
        if self.mesh is not None:
            raise NotImplementedError(
                "row-sharded operands (mesh=) are not ported yet (ROADMAP "
                "queue 1 item 8)")

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


register_family(DenseLinearParams, FamilyOps("dense",
                                             to_dense=_dense_to_dense))


# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FormatAdapter:
    """Everything one format plugs into the front door: construction from
    a dense weight, layer apply, plan execution, and spec recovery."""
    name: str
    make: Callable                     # (w, spec, dtype, device) -> params
    apply: Callable                    # (params, x) -> y
    call: Callable                     # (meta, ready, b) -> C
    pack: Callable                     # (meta, w) -> plan values (numpy)
    spec_of: Callable                  # (meta) -> SparseSpec
    plan_values: Callable = lambda inner: inner.values  # layer -> plan vals
    # (meta, values) -> what ``call`` executes with: the device-ready form
    # a BoundPlan builds once, at bind
    ready: Callable = lambda meta, values: values


_ADAPTERS: Dict[str, FormatAdapter] = {}
_BY_CLS: Dict[type, FormatAdapter] = {}


def register_format(fmt: str, params_cls: type,
                    adapter: FormatAdapter) -> None:
    """The spec registry: consumers (Linear, plans, engines) discover
    formats here instead of per-family isinstance chains."""
    _ADAPTERS[fmt] = adapter
    _BY_CLS[params_cls] = adapter


def _adapter(spec: SparseSpec) -> FormatAdapter:
    """The adapter of ``spec``'s format; the formats not ported yet raise
    ``NotImplementedError`` naming their ROADMAP item."""
    if spec.format in _NOT_PORTED:
        raise NotImplementedError(f"format {spec.format!r}: "
                                  f"{_NOT_PORTED[spec.format]}")
    return _ADAPTERS[spec.format]


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


# ---- per-format plan execution ----------------------------------------
def _incrs_call(meta, prep: ops.PreparedOperand, b) -> torch.Tensor:
    return ops.spmm(prep, torch.as_tensor(b))


def _incrs_ready(meta, values: torch.Tensor) -> ops.PreparedOperand:
    """The stripe operand over ``values``, its indices on their device."""
    return ops.PreparedOperand(meta.fwd_idx.to(values.device),
                               values.detach().contiguous(),
                               (meta.d_out, meta.d_in), meta.section)


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

register_format("bsr", _lin.SparseLinearParams, FormatAdapter(
    "bsr",
    make=_make_bsr, apply=_lin._bsr_apply, call=_bsr_call,
    pack=lambda meta, w: _lin._bsr_pack_values(meta, w),
    spec_of=lambda meta: SparseSpec("bsr", block=meta.block,
                                    pattern=meta.pattern),
    ready=_bsr_ready))


# ----------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class MatmulPlan:
    """The execute half of plan–execute: static kernel metadata built once
    from a concrete spec; ``plan(values, B)`` runs C = A @ B (A = W^T, the
    kernel orientation). ``pack`` turns a dense W (d_in, d_out) into the
    plan's packed values; ``bind`` closes over one values tensor."""
    spec: SparseSpec
    meta: Any                 # family meta; None for an unmasked dense plan

    def __call__(self, values, b):
        """C = A @ B for ``values`` on their device."""
        ad = _adapter(self.spec)
        return ad.call(self.meta, ad.ready(self.meta, values), b)

    def pack(self, w) -> np.ndarray:
        """Dense W (d_in, d_out) -> packed plan values (for 'dense' the
        A = W^T array itself, pattern-masked)."""
        return _adapter(self.spec).pack(self.meta, w)

    def bind(self, values, *, device=None) -> "BoundPlan":
        """A ``BoundPlan`` over ``values`` (a tensor, kept on its device,
        or an array, moved to ``device``, default CUDA)."""
        if not isinstance(values, torch.Tensor):
            values = torch.from_numpy(np.ascontiguousarray(values)).to(
                ops.resolve_device(device))
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

    def __call__(self, b) -> torch.Tensor:
        return _adapter(self.plan.spec).call(self.plan.meta, self._ready, b)

    @property
    def shape(self) -> Tuple[int, int]:
        s = self.plan.shape
        return tuple(self.values.shape) if s is None else s

    @property
    def pattern(self) -> Optional[SparsityPattern]:
        return self.plan.pattern

    @property
    def device(self) -> torch.device:
        return self.values.device


def plan(spec: SparseSpec, rhs_shape: Optional[Tuple[int, ...]] = None
         ) -> MatmulPlan:
    """Build the static half of C = A @ B for ``spec`` — prep once,
    execute many.

    The spec must pin the operand concretely: a ``pattern`` or ``mask``
    for ``bsr`` (a density-only spec needs values to select on — use
    ``Linear.from_dense`` or ``plan_for_operand``), nothing for plain
    ``dense``. ``rhs_shape``, when given, is validated against the
    operand's K.
    """
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
    inner = _adapter(spec).make(np.zeros(pat.shape, np.float32), spec,
                                device="cpu")
    return MatmulPlan(spec, inner.meta)


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
    return Linear.from_dense(w, spec, device=device).bound()


# ----------------------------------------------------------------------
class Linear(torch.nn.Module):
    """ONE sparse/dense linear layer: y = x @ W behind a spec.

    ``values`` is the only ``Parameter``; ``meta`` is the format's static
    metadata (the pattern rides on it). ``inner`` is the format's params
    node over the same tensor, what the registry dispatches on.
    """

    def __init__(self, inner):
        super().__init__()
        self._cls = type(inner)
        adapter_of(inner)                       # a registered format
        self.values = torch.nn.Parameter(inner.values.detach(),
                                         requires_grad=True)
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

    # -- one apply ------------------------------------------------------
    def forward(self, x):
        return apply(self, x)

    # -- views ----------------------------------------------------------
    @property
    def inner(self):
        return self._cls(self.values, self.meta)

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
        """Servable C = A @ B view over the CURRENT values (A = W^T),
        detached from autograd."""
        ad = adapter_of(self.inner)
        return BoundPlan(self.plan, ad.plan_values(self.inner).detach())

    def to_dense(self, values: Optional[torch.Tensor] = None
                 ) -> np.ndarray:
        """Densify W (d_in, d_out) from the current values, or from
        ``values`` laid out like them (their gradient, say)."""
        node = self.inner if values is None else self._cls(values,
                                                           self.meta)
        return _FAMILIES[self._cls].to_dense(node)


def apply(p, x):
    """THE layer apply: dispatches any ``Linear`` (or raw family params
    node) through its family's forward."""
    node = p.inner if isinstance(p, Linear) else p
    return adapter_of(node).apply(node, x)


__all__ = [
    "FORMATS", "SparseSpec", "MatmulPlan", "BoundPlan", "Linear",
    "DenseLinearParams", "DenseLinearMeta", "FormatAdapter",
    "register_format", "adapter_of", "plan", "plan_for_operand", "apply",
]
