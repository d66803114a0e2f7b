"""Logical-axis sharding (MaxText-style).

The port of ``repro.models.sharding``. Every parameter, cache and
optimizer dimension carries a LOGICAL name (``models.model.init_axes``,
``init_cache_axes``, ``train.optimizer.opt_state_axes``); a rule table maps
logical names to mesh axes. Swapping distribution strategies (one pod or
two, FSDP, ZeRO-1, the serve rules) only edits the rule table, never the
model code.

``axis_rules`` activates a mesh (``launch.mesh.Mesh``) and the rule table
(JAX's ``DEFAULT_RULES``, the LM's names and the row-sharded InCRS stripe
names, updated by overrides) for the code run inside it, dropping the mesh
axes the mesh lacks; ``resolve`` maps logical names to a spec, JAX's two
rules kept: a mesh axis is used once (the first logical dim takes it), and
a dim that its mesh axes do not divide stays replicated. A spec is a tuple
of ``None | str | tuple[str, ...]``, one entry a dim: the counterpart of
JAX's ``PartitionSpec``. ``spec_tree`` resolves a tree of axes, and
``shard_slice`` gives the slice of a dim that a mesh coordinate holds.
``models.spmd`` places tensors by these specs and runs the collectives.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

MeshAxes = Union[str, Tuple[str, ...], None]
Spec = Tuple[MeshAxes, ...]

# Default rules for the production mesh ("data", "model") [+ "pod"]: batch
# crosses pod and data; the model-parallel dims map to "model".
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "seq": None,                  # activations: sequence unsharded
    "seq_sp": "model",            # sequence-parallel residual stream
    "attn_q_seq": None,           # query-seq sharding inside attention
    "embed": None,                # d_model of activations
    "vocab": "model",
    "heads": "model",
    "qkv_flat": "model",          # flat q/k/v/o feature dim of projections
    "kv_heads": "model",          # replicated where the axis does not divide
    "head_dim": None,
    "qblocks": ("data", "model"),  # int8 optimizer-moment blocks
    "mlp": "model",               # d_ff
    "experts": None,              # EP maps this to "model" instead of mlp
    "expert_mlp": "model",
    "ssm_inner": "model",
    "ssm_state": None,
    "lru_width": "model",
    "conv_width": None,
    "cache_seq": None,
    "layers": None,               # JAX's stacked groups: never sharded
    "fsdp": "data",               # FSDP dim of weights (embed dim of params)
    "stage": None,
    # Row-sharded InCRS stripe arrays: the leading shard dim splits over
    # these axes, one output-row panel per device; the trailing dims never
    # shard (a stripe row is the kernel's unit of work).
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


def filter_rules(mesh, overrides: Optional[Mapping[str, MeshAxes]] = None
                 ) -> Dict[str, MeshAxes]:
    """``DEFAULT_RULES`` updated by ``overrides``, each rule's mesh axes
    that ``mesh`` lacks dropped (so one table serves every mesh)."""
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    names = mesh.axis_names

    def _filter(ax: MeshAxes) -> MeshAxes:
        if ax is None:
            return None
        if isinstance(ax, str):
            return ax if ax in names else None
        kept = tuple(a for a in ax if a in names)
        return kept if kept else None
    return {k: _filter(v) for k, v in rules.items()}


@contextlib.contextmanager
def axis_rules(mesh, overrides: Optional[Mapping[str, MeshAxes]] = None):
    """Activate ``mesh`` and the rule table (``filter_rules``) for the
    code run inside."""
    prev_mesh, prev_rules = _CTX.mesh, _CTX.rules
    _CTX.mesh = mesh
    _CTX.rules = filter_rules(mesh, overrides)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev_mesh, prev_rules


def current_mesh():
    return _CTX.mesh


def current_rules() -> Dict[str, MeshAxes]:
    """The active rule table (a copy)."""
    return dict(_CTX.rules)


def rule_active(name: str) -> bool:
    """True iff the logical name currently maps to a real mesh axis."""
    return _CTX.mesh is not None and _CTX.rules.get(name) is not None


def axes_of(entry: MeshAxes) -> Tuple[str, ...]:
    """A spec entry's mesh axes as a tuple (``None`` -> ())."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def resolve_with(rules: Mapping[str, MeshAxes], sizes: Mapping[str, int],
                 logical: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None) -> Spec:
    """``resolve`` against an explicit rule table and mesh sizes."""
    spec, used = [], set()
    for i, name in enumerate(logical):
        ax = rules.get(name) if name else None
        if ax is None:
            spec.append(None)
            continue
        flat = axes_of(ax)
        if any(a in used for a in flat):
            spec.append(None)          # second use -> replicate this dim
            continue
        if shape is not None and sizes:
            total = 1
            for a in flat:
                total *= sizes.get(a, 1)
            if shape[i] % total != 0:
                spec.append(None)      # indivisible -> replicate
                continue
        used.update(flat)
        spec.append(ax)
    return tuple(spec)


def resolve(logical: Sequence[Optional[str]],
            shape: Optional[Sequence[int]] = None) -> Spec:
    """Logical axis names -> spec under the active rules (JAX ``resolve``):
    a mesh axis is used at most once (the first logical dim wins), and,
    when ``shape`` is given, a dim that its mesh axes do not divide stays
    replicated."""
    mesh = _CTX.mesh
    return resolve_with(_CTX.rules, mesh.shape if mesh is not None else {},
                        logical, shape)


def is_axes(x) -> bool:
    """True for a logical-axes leaf: a tuple of ``str | None``."""
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def map_axes(fn, tree, *rest):
    """``fn(axes, *leaves)`` over a dict tree of logical-axes tuples (and
    trees of the same structure in ``rest``)."""
    if is_axes(tree):
        return fn(tree, *rest)
    return {k: map_axes(fn, v, *(r[k] for r in rest))
            for k, v in tree.items()}


def spec_tree(axes_tree, shape_tree=None):
    """Map a dict tree of logical-axes tuples to specs; ``shape_tree``
    (same structure, leaves with ``.shape``) turns on the divisibility
    rule."""
    if shape_tree is None:
        return map_axes(lambda ax: resolve(ax), axes_tree)
    return map_axes(lambda ax, t: resolve(ax, tuple(t.shape)), axes_tree,
                    shape_tree)


def shard_slice(size: int, entry: MeshAxes, sizes: Mapping[str, int],
                coord: Mapping[str, int]) -> slice:
    """The slice of a dim of ``size`` that mesh coordinate ``coord`` (axis
    -> index) holds under the spec entry ``entry``: the dim splits into
    equal parts over the entry's axes, the first axis outermost."""
    flat = axes_of(entry)
    n, idx = 1, 0
    for a in flat:
        n *= sizes[a]
        idx = idx * sizes[a] + coord[a]
    if size % n:
        raise ValueError(f"a dim of {size} does not split over {flat} "
                         f"({n} parts)")
    step = size // n
    return slice(idx * step, (idx + 1) * step)


def shard_shape(shape: Sequence[int], spec: Spec,
                sizes: Mapping[str, int]) -> Tuple[int, ...]:
    """The shape one mesh coordinate holds of a tensor of ``shape``."""
    out = []
    for dim, entry in zip(shape, spec):
        n = 1
        for a in axes_of(entry):
            n *= sizes[a]
        out.append(dim // n)
    return tuple(out)


__all__ = ["DEFAULT_RULES", "INCRS_STRIPE_AXES", "MeshAxes", "Spec",
           "axes_of", "axis_rules", "current_mesh", "current_rules",
           "filter_rules", "is_axes", "map_axes", "resolve", "resolve_with",
           "rule_active", "shard_shape", "shard_slice", "spec_tree"]
