"""The sparsity pattern of one weight, and the selections that make it.

The port of ``repro.sparse.pattern``, the part the plan–execute serving
slice needs: ``SparsityPattern`` (element mask of W + lineage ``uid`` and
``version``, a registry of the packed forms built for it),
``expand_block_mask`` and the selections ``magnitude_mask`` (element or
block granularity), ``nm_mask`` and ``parse_nm``. Numpy only; the tests
hold every mask equal to the JAX package's bit for bit.

The family registry keeps only ``to_dense``, what ``Linear.to_dense``
needs. ``PruneSchedule`` and the lifecycle moves (``repack``,
``magnitude_repack``, ``repack_onto``) are not ported yet (ROADMAP queue
1 item 5).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, Optional

import numpy as np

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
    thresh = np.partition(np.abs(w).ravel(), -keep)[-keep]
    return (np.abs(w) >= thresh) & (w != 0.0)


# ----------------------------------------------------------------------
# Family registry: ``sparse.linear`` and ``sparse.api`` register each params
# class with how to densify its current values.
@dataclasses.dataclass(frozen=True)
class FamilyOps:
    name: str
    # node -> dense W (d_in, d_out) of the node's CURRENT values
    to_dense: Callable[[Any], np.ndarray]


_FAMILIES: Dict[type, FamilyOps] = {}


def register_family(cls: type, ops: FamilyOps) -> None:
    _FAMILIES[cls] = ops


def get_pattern(node: Any) -> Optional[SparsityPattern]:
    return getattr(node.meta, "pattern", None)


__all__ = [
    "SparsityPattern", "FamilyOps", "magnitude_mask", "nm_mask",
    "parse_nm", "expand_block_mask", "register_family", "get_pattern",
]
