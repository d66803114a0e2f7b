"""Placement and collectives of a model over a device mesh, in one process.

JAX hands a sharded program to XLA's SPMD partitioner, which places each
array by its ``PartitionSpec`` and inserts the collectives. The port does
both in its own code, here:

* **Placement.** A ``Sharded`` tensor is a grid of shards, one tensor for
  each mesh coordinate (row-major over ``mesh.coords()``), on that
  coordinate's device, each of the shape ``sharding.shard_shape`` gives
  its spec (a dim splits into equal parts over its spec entry's axes, the
  first axis outermost). ``place`` cuts a tensor into one; ``full``
  assembles it again. A per-coordinate list of tensors with no spec (an
  activation, a gradient) is what the collectives take and return.
* **Collectives.** ``all_gather``, ``reduce_scatter``, ``all_reduce`` and
  ``all_to_all`` over named mesh axes, each run as one
  ``torch.autograd.Function`` over every coordinate, whose backward is the
  exact adjoint: an all-gather's is a reduce-scatter, an all-reduce's an
  all-reduce, a reduce-scatter's an all-gather, an all-to-all's the
  reverse all-to-all. A group is the coordinates that differ only on the
  named axes, ordered as a spec entry orders its shards. Each call, in the
  forward and in the backward, adds to ``mesh.collectives`` by kind, per
  device: ``count``, ``result_bytes`` (one device's result) and
  ``wire_bytes``, JAX's ring formulas (``repro.launch.dryrun``): with g
  devices in a group, an all-reduce moves 2 (g - 1) / g of its bytes, an
  all-gather (g - 1) / g of the gathered result, a reduce-scatter (g - 1)
  times the scattered result, an all-to-all (g - 1) / g. A group of one
  moves nothing and is not counted (nor run).

Today a collective is a tensor move and a sum inside one process (a mesh
of one card named N times, of distinct cards, of the CPU or of ``meta``).
This module is the only place that knows how a collective is done, so a
later change can back it with ``torch.distributed`` across processes
without touching the model.

``shard_model`` places a ``models.model.Model``'s parameters by their
logical axes under a rule table (a ``model.ShardedModel``);
``gather_model`` assembles a one-device ``Model`` from one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from . import sharding as sh

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")


def _check_axes(mesh, axes: Sequence[str]) -> Tuple[str, ...]:
    axes = tuple(axes)
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"mesh {mesh.axis_names} has no axis {a!r}")
    if len(set(axes)) != len(axes):
        raise ValueError(f"axes repeat: {axes}")
    return axes


def group_size(mesh, axes: Sequence[str]) -> int:
    """Devices in one group over ``axes``."""
    sizes = mesh.shape
    return int(np.prod([sizes[a] for a in _check_axes(mesh, axes)]))


def groups(mesh, axes: Sequence[str]) -> List[List[int]]:
    """The coordinate indices of each group over ``axes``: coordinates
    equal on every other axis, in the order of the combined index over
    ``axes`` (the first axis outermost, as a spec entry's shards)."""
    axes = _check_axes(mesh, axes)
    idx = np.arange(mesh.size).reshape(mesh.devices.shape)
    pos = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(idx.ndim) if i not in pos]
    return idx.transpose(rest + pos).reshape(
        -1, group_size(mesh, axes)).tolist()


def n_coords(mesh) -> int:
    """The coordinates a program runs: every one, or on a mesh of ``meta``
    devices (shapes, no values: the dry run) coordinate 0 alone. There
    every coordinate's program is coordinate 0's (``resolve`` gives every
    shard of a tensor one shape), so each ``Sharded`` holds coordinate 0's
    shard, each collective shapes its result from coordinate 0's operand
    and counts what every device moves."""
    return 1 if mesh.device_list[0].type == "meta" else mesh.size


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _count(mesh, kind: str, g: int, result: torch.Tensor) -> None:
    nbytes = _bytes(result)
    wire = {"all-reduce": 2 * (g - 1) / g * nbytes,
            "all-gather": (g - 1) / g * nbytes,
            "reduce-scatter": (g - 1) * nbytes,
            "all-to-all": (g - 1) / g * nbytes}[kind]
    rec = mesh.collectives[kind]
    rec["count"] += 1
    rec["result_bytes"] += nbytes
    rec["wire_bytes"] += wire


def _run(mesh, kind: str, axes, dims, xs, op: str = "sum"):
    """One collective over every group; returns one tensor a coordinate,
    each its own (never another coordinate's object)."""
    g = group_size(mesh, axes)
    if len(xs) < mesh.size:             # a meta mesh: coordinate 0 alone
        x = xs[0]
        res = {"all-reduce": lambda: x,
               "all-gather": lambda: torch.cat([x] * g, dims[0]),
               "reduce-scatter": lambda: x.chunk(g, dims[0])[0],
               "all-to-all": lambda: torch.cat(
                   [x.chunk(g, dims[0])[0]] * g, dims[1])}[kind]()
        _count(mesh, kind, g, res)
        return [res.clone()]
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    for grp in groups(mesh, axes):
        dev = xs[grp[0]].device
        parts = [xs[i].to(dev) for i in grp]
        if kind == "all-reduce":
            total = parts[0]
            for p in parts[1:]:
                total = torch.maximum(total, p) if op == "max" else total + p
            res = [total] * g
        elif kind == "all-gather":
            res = [torch.cat(parts, dims[0])] * g
        elif kind == "reduce-scatter":
            total = parts[0]
            for p in parts[1:]:
                total = total + p
            res = list(total.chunk(g, dims[0]))
        else:                       # all-to-all: split dims[0], cat dims[1]
            chunks = [p.chunk(g, dims[0]) for p in parts]
            res = [torch.cat([c[j] for c in chunks], dims[1])
                   for j in range(g)]
        for i, r in zip(grp, res):
            out[i] = r.to(xs[i].device, copy=True).contiguous()
    _count(mesh, kind, g, out[0])
    return out


_ADJOINT = {"all-reduce": "all-reduce", "all-gather": "reduce-scatter",
            "reduce-scatter": "all-gather", "all-to-all": "all-to-all"}


class _Collective(torch.autograd.Function):
    """A sum collective over every coordinate at once; the backward runs
    its adjoint (counted as well)."""

    @staticmethod
    def forward(ctx, mesh, kind, axes, dims, *xs):
        ctx.mesh, ctx.kind, ctx.axes, ctx.dims = mesh, kind, axes, dims
        return tuple(_run(mesh, kind, axes, dims, xs))

    @staticmethod
    def backward(ctx, *gs):
        dims = ctx.dims[::-1] if ctx.kind == "all-to-all" else ctx.dims
        return (None, None, None, None) + tuple(
            _run(ctx.mesh, _ADJOINT[ctx.kind], ctx.axes, dims, gs))


def _apply(xs, mesh, kind, axes, dims=()):
    if len(xs) != n_coords(mesh):
        raise ValueError(f"a collective takes one tensor a coordinate "
                         f"({n_coords(mesh)}), got {len(xs)}")
    axes = _check_axes(mesh, axes)
    if group_size(mesh, axes) == 1:
        return list(xs)
    dims = tuple(d % xs[0].ndim for d in dims)
    return list(_Collective.apply(mesh, kind, axes, dims, *xs))


def all_reduce(xs, mesh, axes: Sequence[str]) -> List[torch.Tensor]:
    """Sum over each group; every member gets the sum."""
    return _apply(xs, mesh, "all-reduce", axes)


def all_reduce_max(xs, mesh, axes: Sequence[str]) -> List[torch.Tensor]:
    """Elementwise max over each group, outside autograd (the shift of a
    log-sum-exp, which carries no gradient)."""
    axes = _check_axes(mesh, axes)
    if group_size(mesh, axes) == 1:
        return [x.detach() for x in xs]
    with torch.no_grad():
        return _run(mesh, "all-reduce", axes, (), [x.detach() for x in xs],
                    op="max")


def all_gather(xs, mesh, axes: Sequence[str], dim: int
               ) -> List[torch.Tensor]:
    """Concatenate each group's tensors along ``dim``, in group order."""
    return _apply(xs, mesh, "all-gather", axes, (dim,))


def reduce_scatter(xs, mesh, axes: Sequence[str], dim: int
                   ) -> List[torch.Tensor]:
    """Sum over each group and split the sum along ``dim``: member j gets
    part j."""
    return _apply(xs, mesh, "reduce-scatter", axes, (dim,))


def all_to_all(xs, mesh, axes: Sequence[str], split_dim: int,
               concat_dim: int) -> List[torch.Tensor]:
    """Member i splits its tensor along ``split_dim`` into g parts and sends
    part j to member j, which concatenates what it gets along
    ``concat_dim`` in group order."""
    return _apply(xs, mesh, "all-to-all", axes, (split_dim, concat_dim))


# ----------------------------------------------------------------------
@dataclasses.dataclass
class Sharded:
    """A tensor of global ``shape`` placed on ``mesh`` by ``spec``:
    ``shards[i]`` is coordinate i's part (``mesh.coords()[i]``), or None
    where the coordinate holds none (a layer's optimizer moments, owned by
    other data coordinates: ``train.optimizer.moment_layout``)."""
    mesh: object
    spec: sh.Spec
    shape: Tuple[int, ...]
    shards: List[torch.Tensor]

    def slices(self, i: int) -> Tuple[slice, ...]:
        """The global region that coordinate ``i`` holds."""
        coord, sizes = self.mesh.coords()[i], self.mesh.shape
        return tuple(sh.shard_slice(n, e, sizes, coord)
                     for n, e in zip(self.shape, self.spec))

    def span(self, i: int, dim: int) -> Tuple[int, int]:
        s = self.slices(i)[dim]
        return s.start, s.stop

    def held(self) -> List[torch.Tensor]:
        """The shards some coordinate holds."""
        return [t for t in self.shards if t is not None]

    @property
    def dtype(self) -> torch.dtype:
        return self.held()[0].dtype

    @torch.no_grad()
    def full(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: the first shard's)."""
        dev = self.held()[0].device if device is None else device
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for i, t in enumerate(self.shards):
            if t is not None:
                out[self.slices(i)] = t.detach().to(dev)
        return out


@torch.no_grad()
def place(t: torch.Tensor, mesh, spec: sh.Spec, *,
          parameter: bool = False) -> Sharded:
    """Cut ``t`` by ``spec`` onto ``mesh``'s devices (copies; as
    ``nn.Parameter`` leaves with ``parameter``)."""
    if len(spec) != t.ndim:
        raise ValueError(f"spec {spec} does not name the {t.ndim} dims of "
                         f"{tuple(t.shape)}")
    out = Sharded(mesh, tuple(spec), tuple(t.shape), [])
    for i, dev in enumerate(mesh.device_list[:n_coords(mesh)]):
        part = t[out.slices(i)].to(dev, copy=True).contiguous()
        out.shards.append(nn.Parameter(part) if parameter else part)
    return out


def zeros(shape, dtype, mesh, spec: sh.Spec) -> Sharded:
    """A zero ``Sharded`` of ``shape``."""
    loc = sh.shard_shape(shape, spec, mesh.shape)
    return Sharded(mesh, tuple(spec), tuple(shape),
                   [torch.zeros(loc, dtype=dtype, device=d)
                    for d in mesh.device_list[:n_coords(mesh)]])


# ----------------------------------------------------------------------
def shard_model(model, mesh, overrides: Optional[Dict[str, sh.MeshAxes]]
                = None):
    """``model``'s parameters placed on ``mesh`` by their logical axes
    (``model.init_axes``) under ``DEFAULT_RULES`` updated by
    ``overrides`` (``sharding.resolve``, shapes checked), and a
    block-sparse FFN's masks whole on every coordinate: a
    ``model.ShardedModel``. ``convert.model_from_jax`` then
    ``shard_model`` carries JAX's weights onto a mesh."""
    from .model import ShardedModel, init_axes
    cfg = model.cfg
    rules = sh.filter_rules(mesh, overrides)
    axes = init_axes(cfg)
    params = {}
    for name, p in model.named_parameters():
        spec = sh.resolve_with(rules, mesh.shape, axes[name],
                               tuple(p.shape))
        params[name] = place(p.detach(), mesh, spec, parameter=True)
    masks = {name: place(b, mesh, (None,) * b.ndim).shards
             for name, b in model.named_buffers()}
    return ShardedModel(cfg, mesh, rules, params, masks)


@torch.no_grad()
def gather_model(sharded, device=None):
    """The one-device ``Model`` of a ``ShardedModel``'s weights (and
    masks), on ``device`` (default: the first coordinate's)."""
    from .model import Model
    dev = sharded.mesh.device_list[0] if device is None else device
    model = Model(sharded.cfg, device=dev)
    for name, p in model.named_parameters():
        p.copy_(sharded.params[name].full(dev))
    for name, b in model.named_buffers():
        b.copy_(sharded.masks[name][0])
    return model


__all__ = ["KINDS", "Sharded", "all_gather", "all_reduce", "all_reduce_max",
           "all_to_all", "gather_model", "group_size", "groups",
           "n_coords", "place", "reduce_scatter",
           "shard_model", "zeros"]
