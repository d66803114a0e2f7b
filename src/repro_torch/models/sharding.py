"""Logical-axis sharding rules: the part the row-sharded InCRS layer reads.

The port of ``repro.models.sharding``'s context and rule table, cut to
what ``sparse.linear``'s sharded packer consults when it is given no mesh
or no shard axis: ``axis_rules`` activates a mesh (``launch.mesh.Mesh``)
and a rule table for the code run inside it, ``current_mesh`` and
``rule_active`` read them, and ``resolve`` maps logical names to mesh
axes. Only the InCRS stripe names are in the table: the LM's logical axes
(batch, heads, mlp, ...) come with the LM stack.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[str, Tuple[str, ...], None]

# The leading shard dim of the sharded stripe arrays splits over these
# axes, one output-row panel per device; the trailing dims never shard (a
# stripe row is the kernel's unit of work).
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "incrs_shard": ("data", "model"),
    "incrs_row": None,            # padded output rows within one shard
    "incrs_section": None,        # section axis of the stripe arrays
    "incrs_slot": None,           # slot (smax) axis of the stripe arrays
}

# Logical axes of the sharded stripe arrays.
INCRS_STRIPE_AXES = ("incrs_shard", "incrs_row", "incrs_section",
                     "incrs_slot")


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Dict[str, MeshAxes] = dict(DEFAULT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def axis_rules(mesh, overrides: Optional[Dict[str, MeshAxes]] = None):
    """Activate ``mesh`` and the rule table (``DEFAULT_RULES`` updated by
    ``overrides``) for the code run inside; a rule's axes that the mesh
    lacks are dropped, so one table serves every mesh."""
    prev_mesh, prev_rules = _CTX.mesh, _CTX.rules
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)

    def _filter(ax: MeshAxes) -> MeshAxes:
        names = mesh.axis_names
        if ax is None:
            return None
        if isinstance(ax, str):
            return ax if ax in names else None
        kept = tuple(a for a in ax if a in names)
        return kept if kept else None
    _CTX.mesh = mesh
    _CTX.rules = {k: _filter(v) for k, v in rules.items()}
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev_mesh, prev_rules


def current_mesh():
    return _CTX.mesh


def rule_active(name: str) -> bool:
    """True iff the logical name currently maps to a real mesh axis."""
    return _CTX.mesh is not None and _CTX.rules.get(name) is not None


def resolve(logical: Sequence[Optional[str]]) -> Tuple[MeshAxes, ...]:
    """Logical axis names -> mesh axes under the active rules, one entry a
    dim (JAX's ``PartitionSpec`` entries); a mesh axis is used at most
    once, the first logical dim taking it."""
    spec, used = [], set()
    for name in logical:
        ax = _CTX.rules.get(name) if name else None
        if ax is None:
            spec.append(None)
            continue
        flat = (ax,) if isinstance(ax, str) else tuple(ax)
        if any(a in used for a in flat):
            spec.append(None)
            continue
        used.update(flat)
        spec.append(ax)
    return tuple(spec)


__all__ = ["DEFAULT_RULES", "INCRS_STRIPE_AXES", "axis_rules",
           "current_mesh", "rule_active", "resolve"]
