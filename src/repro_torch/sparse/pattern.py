"""The sparsity pattern of one weight, and the selections that make it.

The port of ``repro.sparse.pattern``, the part the plan–execute serving
slice needs: ``SparsityPattern`` (element mask of W + lineage ``uid`` and
``version``, a registry of the packed forms built for it),
``expand_block_mask`` and the selections ``magnitude_mask`` (element or
block granularity), ``nm_mask`` and ``parse_nm``. Numpy only; the tests
hold every mask equal to the JAX package's bit for bit.

The lifecycle: ``PruneSchedule`` says when a train loop re-prunes and
to what density (the cubic Zhu–Gupta curve). ``repack(node, new_mask)``
densifies a layer's current values, evolves its pattern (same ``uid``,
``version + 1``) and packs under the new mask: surviving values carry
over, slots new to the pattern start at 0.0. ``magnitude_repack`` picks
the new mask by magnitude at the family's granularity, and
``repack_onto`` moves a per-slot tensor (an AdamW moment) onto a
repacked node's layout. Each family registers how to densify, pack and
select (``FamilyOps``); a repacked node keeps its values, and builds its
device index tensors, on the device of the old node's values.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core.bsr import magnitude_block_mask

_uids = itertools.count(1)


@dataclasses.dataclass(eq=False)
class SparsityPattern:
    """Element occupancy of one weight W (d_in, d_out) + version counter.

    ``eq=False`` -> identity hash/eq: a pattern names one lineage, and
    two equal masks are still two patterns. ``uid``
    names the lineage (stable across ``evolve``); ``(uid, version)`` names
    one immutable snapshot — never mutate ``mask`` in place, evolve instead.
    """
    mask: np.ndarray                  # (d_in, d_out) bool
    version: int = 0
    uid: int = dataclasses.field(default_factory=lambda: next(_uids))
    # family name -> packed metadata built for THIS (uid, version); filled
    # by the family packers in ``sparse.linear``.
    packed: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.mask = np.ascontiguousarray(np.asarray(self.mask, bool))
        if self.mask.ndim != 2:
            raise ValueError(f"pattern mask must be 2-D (d_in, d_out), "
                             f"got shape {self.mask.shape}")

    # ------------------------------------------------------------------
    @property
    def shape(self):
        return self.mask.shape

    @property
    def d_in(self) -> int:
        return self.mask.shape[0]

    @property
    def d_out(self) -> int:
        return self.mask.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.mask.sum())

    @property
    def density(self) -> float:
        return self.nnz / float(self.mask.size) if self.mask.size else 0.0

    # ------------------------------------------------------------------
    def evolve(self, new_mask: np.ndarray,
               version: Optional[int] = None) -> "SparsityPattern":
        """Next snapshot of this lineage: same ``uid``, ``version + 1``
        (or an explicit ``version`` — checkpoint restore re-creates a
        mid-schedule snapshot), fresh empty ``packed`` registry."""
        new_mask = np.asarray(new_mask, bool)
        if new_mask.shape != self.mask.shape:
            raise ValueError(f"evolved mask shape {new_mask.shape} != "
                             f"pattern shape {self.mask.shape}")
        return SparsityPattern(new_mask,
                               self.version + 1 if version is None
                               else version, uid=self.uid)

    def block_mask(self, block: int) -> np.ndarray:
        """Out-major block occupancy of W^T, shape (d_out//block,
        d_in//block) — the mask ``SparseLinear``'s BSR packer consumes. A
        block is live iff any of its elements is."""
        d_in, d_out = self.mask.shape
        if d_in % block or d_out % block:
            raise ValueError(f"block={block} must divide the pattern "
                             f"shape {self.mask.shape}")
        mt = self.mask.T.reshape(d_out // block, block, d_in // block, block)
        return mt.any(axis=(1, 3))


def expand_block_mask(block_mask: np.ndarray, block: int) -> np.ndarray:
    """Inverse of ``SparsityPattern.block_mask``: out-major block occupancy
    of W^T -> element mask of W (every element of a live block is live —
    BSR stores, and trains, whole tiles)."""
    elem_t = np.kron(np.asarray(block_mask, bool),
                     np.ones((block, block), bool))
    return np.ascontiguousarray(elem_t.T)


# ----------------------------------------------------------------------
def parse_nm(policy: str) -> tuple:
    """``"n:m"`` -> ``(n, m)`` with 0 < n <= m; anything else raises."""
    try:
        n, m = (int(x) for x in str(policy).split(":"))
    except ValueError:
        raise ValueError(
            f"structured selection policy must look like 'n:m' (e.g. "
            f"'2:4'), got {policy!r}") from None
    if not 0 < n <= m:
        raise ValueError(f"n:m policy needs 0 < n <= m, got {n}:{m}")
    return n, m


def nm_mask(w: np.ndarray, n: int, m: int) -> np.ndarray:
    """Structured N:M mask of W (d_in, d_out): within every group of ``m``
    consecutive elements along d_in (the contraction dimension of
    ``y = x @ W`` — the axis N:M hardware groups), keep EXACTLY the ``n``
    largest by magnitude. Every group keeps exactly ``n`` survivors — ties
    (including all-zero groups) break by position, because the structured
    format reserves n slots per group unconditionally.
    """
    w = np.asarray(w, np.float32)
    if w.ndim != 2:
        raise ValueError(f"nm_mask needs a 2-D weight, got shape {w.shape}")
    if not 0 < n <= m:
        raise ValueError(f"n:m needs 0 < n <= m, got {n}:{m}")
    d_in, d_out = w.shape
    if d_in % m:
        raise ValueError(f"d_in={d_in} must divide into groups of m={m}")
    groups = np.abs(w).reshape(d_in // m, m, d_out)
    top = np.argpartition(-groups, n - 1, axis=1)[:, :n]
    mask = np.zeros(groups.shape, bool)
    np.put_along_axis(mask, top, True, axis=1)
    return np.ascontiguousarray(mask.reshape(d_in, d_out))


def magnitude_mask(w: np.ndarray, density: Optional[float],
                   block: Optional[int] = None, *,
                   policy: str = "magnitude") -> np.ndarray:
    """Element mask of W keeping the top-``density`` fraction by magnitude
    with ONE global threshold — the same selection as the packers'
    historical ``_prune_magnitude``, so from-dense construction through the
    lifecycle is bit-identical to the pre-lifecycle constructors.

    ``density`` of None (or >= 1) keeps exactly the non-zeros, matching
    what ``CRS.from_dense`` on the unpruned weight would store. Exact
    zeros never survive a magnitude selection (they cannot outrank a live
    value), which is what makes a repeated magnitude re-prune monotone:
    slots pruned to 0.0 stay dead. ``block`` switches to block granularity
    over W^T (``core.bsr.magnitude_block_mask`` semantics, expanded back to
    elements) — the BSR family's selection rule.

    ``policy`` selects the rule: ``"magnitude"`` (default, the global
    threshold above) or a structured ``"n:m"`` string like ``"2:4"``
    (``nm_mask`` — exactly n survivors per m-group along d_in; ``density``
    and ``block`` do not apply and must be left unset).
    """
    if policy != "magnitude":
        n, m = parse_nm(policy)
        if block is not None:
            raise ValueError("n:m selection is element-level; it cannot be "
                             "combined with block granularity")
        if density is not None and abs(density - n / m) > 1e-9:
            raise ValueError(f"policy {policy!r} fixes density at "
                             f"{n}/{m}; drop density= or pass {n / m}")
        return nm_mask(w, n, m)
    w = np.asarray(w, np.float32)
    if block is not None:
        wt = np.ascontiguousarray(w.T)
        bm = magnitude_block_mask(wt, (block, block),
                                  1.0 if density is None else density)
        # All-zero blocks must stay dead regardless of how generous the
        # density is (magnitude_block_mask's threshold hits 0.0 once
        # n_keep exceeds the live-block count and would mark them live) —
        # the block-granularity analogue of the "& (w != 0)" guard below.
        nbr, nbc = wt.shape[0] // block, wt.shape[1] // block
        live = (wt != 0.0).reshape(nbr, block, nbc, block).any(axis=(1, 3))
        return expand_block_mask(bm & live, block)
    if density is None or density >= 1.0:
        return w != 0.0
    keep = max(1, int(round(w.size * density)))
    live = w != 0.0
    # The keep-th largest |w| over all elements: among the non-zeros when
    # there are at least keep of them, else 0.0. Partitioning only the
    # non-zeros gives the same threshold (a repacked layer is mostly zeros).
    nz = np.abs(w[live])
    thresh = np.partition(nz, -keep)[-keep] if keep <= nz.size \
        else np.float32(0.0)
    return (np.abs(w) >= thresh) & live


# ----------------------------------------------------------------------
def validate_schedule(total_steps: int, final_density: float,
                      warmup_frac: float) -> None:
    """Input validation of the cubic schedule (``PruneSchedule`` and
    ``prune.sparsity_schedule``)."""
    if not 0.0 < final_density <= 1.0:
        raise ValueError(f"final_density must be in (0, 1], "
                         f"got {final_density}")
    if total_steps <= 0:
        raise ValueError(f"total_steps must be positive, got {total_steps}")
    if not 0.0 <= warmup_frac < 1.0:
        raise ValueError(f"warmup_frac must be in [0, 1), got {warmup_frac}")


@dataclasses.dataclass(frozen=True)
class PruneSchedule:
    """WHEN to re-prune and to WHAT density.

    ``density_at`` is the cubic Zhu & Gupta curve (dense through
    ``warmup_frac`` of training, then decaying to ``final_density`` at
    ``total_steps``); ``every`` sets the re-prune cadence in steps.
    """
    final_density: float
    total_steps: int
    warmup_frac: float = 0.1
    every: int = 1

    def __post_init__(self):
        validate_schedule(self.total_steps, self.final_density,
                          self.warmup_frac)
        if self.every <= 0:
            raise ValueError(f"every must be positive, got {self.every}")

    def density_at(self, step: int) -> float:
        t0 = self.warmup_frac * self.total_steps
        if step <= t0:
            return 1.0
        f = min(1.0, (step - t0) / max(self.total_steps - t0, 1))
        return self.final_density + \
            (1.0 - self.final_density) * (1 - f) ** 3

    def due(self, step: int) -> bool:
        """True when a train loop should re-prune AT this step: on the
        ``every`` cadence, once the schedule has left the dense warmup."""
        return step % self.every == 0 and self.density_at(step) < 1.0


# ----------------------------------------------------------------------
# Family registry: ``sparse.linear`` and ``sparse.api`` register each params
# class with the operations the lifecycle needs. Everything below
# dispatches on type(node).
@dataclasses.dataclass(frozen=True)
class FamilyOps:
    name: str
    # node -> dense W (d_in, d_out) of the node's CURRENT values
    to_dense: Callable[[Any], np.ndarray]
    # (dense W, pattern, like_node) -> new node packed under pattern, with
    # like_node's section/block, dtype and device
    pack: Callable[[np.ndarray, SparsityPattern, Any], Any]
    # (meta, dense W) -> values (numpy) packed into an EXISTING meta
    pack_values: Callable[[Any, np.ndarray], np.ndarray]
    # (dense W, density, like_node) -> element mask at the family's
    # granularity (elementwise for InCRS, whole blocks for BSR)
    default_mask: Callable[[np.ndarray, float, Any], np.ndarray]
    # "element" families accept n:m; "block" families prune whole tiles
    granularity: str = "element"
    # (values numpy, like_node, dtype) -> values placed as like_node's are;
    # None: one tensor on the device of like_node's values
    put_values: Optional[Callable[[np.ndarray, Any, Any], Any]] = None


_FAMILIES: Dict[type, FamilyOps] = {}


def register_family(cls: type, ops: FamilyOps) -> None:
    _FAMILIES[cls] = ops


def is_lifecycle_node(x: Any) -> bool:
    """True for a sparse-linear params object the lifecycle can repack:
    a registered family carrying a pattern, not stacked."""
    if type(x) not in _FAMILIES or get_pattern(x) is None:
        return False
    return not is_stacked_node(x)


def is_stacked_node(x: Any) -> bool:
    """True for a registered params object whose values carry a leading
    per-stage axis over one shared pattern (``api.stack_init``, the
    pipeline's stacks): the stages disagree on what to prune, and the
    shared meta cannot hold per-stage patterns, so it cannot be
    repacked."""
    if type(x) not in _FAMILIES or get_pattern(x) is None:
        return False
    idx = getattr(x.meta, "fwd_idx", None)
    if not isinstance(idx, torch.Tensor):       # none, or one a shard
        return False
    return x.values.ndim != idx.ndim


def get_pattern(node: Any) -> Optional[SparsityPattern]:
    return getattr(node.meta, "pattern", None)


def _family(node: Any) -> FamilyOps:
    fam = _FAMILIES.get(type(node))
    if fam is None:
        raise TypeError(f"{type(node).__name__} is not a registered "
                        f"sparse-linear family")
    return fam


def node_to_dense(node: Any) -> np.ndarray:
    """Dense W (d_in, d_out) of a node's current values (host numpy)."""
    return _family(node).to_dense(node)


# ----------------------------------------------------------------------
def repack(node: Any, new_mask: np.ndarray, *,
           version: Optional[int] = None) -> Any:
    """Re-pack ``node`` under ``new_mask``: values surviving the pattern
    change carry over exactly, slots new to the pattern start at 0.0. The
    returned node carries an evolved pattern (same ``uid``, version
    bumped, or pinned to ``version``) and fresh metadata on the device of
    ``node``'s values."""
    fam = _family(node)
    return _repack_dense(node, fam.to_dense(node), new_mask, version=version)


def _repack_dense(node: Any, w: np.ndarray, new_mask: np.ndarray, *,
                  version: Optional[int] = None) -> Any:
    fam = _family(node)
    pat = get_pattern(node)
    if pat is None:
        raise ValueError(f"{type(node).__name__} carries no SparsityPattern"
                         f" — rebuild it through a lifecycle constructor")
    return fam.pack(w, pat.evolve(new_mask, version=version), node)


def magnitude_repack(node: Any, density: float, *,
                     policy: str = "magnitude") -> Any:
    """Re-prune ``node`` to ``density`` by magnitude of its CURRENT values
    (elementwise for InCRS and dense, whole blocks for BSR). Returns
    ``node`` itself, with no version bump, when the selection does not
    move the mask.

    ``policy="n:m"`` (e.g. ``"2:4"``) keeps exactly n of every m along
    d_in instead (density n/m); element-level families only."""
    fam = _family(node)
    w = fam.to_dense(node)
    if policy != "magnitude":
        n, m = parse_nm(policy)
        if fam.granularity != "element":
            raise ValueError(
                f"n:m selection is element-level; the {fam.name!r} family "
                f"prunes whole blocks — use policy='magnitude'")
        new_mask = nm_mask(w, n, m)
    else:
        new_mask = fam.default_mask(w, density, node)
    pat = get_pattern(node)
    if pat is not None and np.array_equal(new_mask, pat.mask):
        return node
    return _repack_dense(node, w, new_mask)


def repack_onto(node: Any, like: Any) -> Any:
    """Repack ``node``'s values onto ``like``'s already-packed metadata:
    ``like`` with ``node``'s per-slot values moved to its layout, in
    ``node``'s dtype, on the device of ``like``'s values. Used for AdamW
    moments after a repack: surviving slots keep their moments, slots new
    to the pattern start at 0."""
    fam = _family(node)
    if type(like) is not type(node):
        raise TypeError(f"repack_onto: {type(node).__name__} vs "
                        f"{type(like).__name__}")
    vals = fam.pack_values(like.meta, fam.to_dense(node))
    dtype = _values_dtype(node)
    if fam.put_values is not None:
        return dataclasses.replace(like,
                                   values=fam.put_values(vals, like, dtype))
    return dataclasses.replace(like, values=torch.from_numpy(
        np.ascontiguousarray(vals)).to(device=like.values.device,
                                        dtype=dtype))


def _values_dtype(node: Any) -> torch.dtype:
    """The dtype of a node's values: one tensor, or one a shard."""
    v = node.values
    return (v if isinstance(v, torch.Tensor) else v[0]).dtype


__all__ = [
    "SparsityPattern", "PruneSchedule", "FamilyOps",
    "magnitude_mask", "nm_mask", "parse_nm", "expand_block_mask",
    "validate_schedule",
    "register_family", "is_lifecycle_node", "is_stacked_node",
    "get_pattern", "node_to_dense",
    "repack", "magnitude_repack", "repack_onto",
]
