"""Placement and collectives of a model over a device mesh.

JAX hands a sharded program to XLA's SPMD partitioner, which places each
array by its ``PartitionSpec`` and inserts the collectives. The port does
both in its own code, here:

* **Placement.** A ``Sharded`` tensor is a grid of shards, one tensor for
  each coordinate the process runs (``local_coords``), on that
  coordinate's device, each of the shape ``sharding.shard_shape`` gives
  its spec (a dim splits into equal parts over its spec entry's axes, the
  first axis outermost). ``place`` cuts a tensor into one; ``full``
  assembles it again. A list of tensors with no spec, one a coordinate
  the process runs (an activation, a gradient), is what the collectives
  take and return.
* **Collectives.** ``all_gather``, ``reduce_scatter``, ``all_reduce`` and
  ``all_to_all`` over named mesh axes, each run as one
  ``torch.autograd.Function`` over the process's coordinates, whose
  backward is the exact adjoint: an all-gather's is a reduce-scatter, an
  all-reduce's an all-reduce, a reduce-scatter's an all-gather, an
  all-to-all's the reverse all-to-all. A group is the coordinates that
  differ only on the named axes, ordered as a spec entry orders its
  shards. Each call, in the forward and in the backward, adds to
  ``mesh.collectives`` by kind, per device: ``count``, ``result_bytes``
  (one device's result) and ``wire_bytes``, JAX's ring formulas
  (``repro.launch.dryrun``): with g devices in a group, an all-reduce
  moves 2 (g - 1) / g of its bytes, an all-gather (g - 1) / g of the
  gathered result, a reduce-scatter (g - 1) times the scattered result,
  an all-to-all (g - 1) / g. A group of one moves nothing and is not
  counted (nor run).

Three ways to run a mesh (``launch.mesh``): one process runs every
coordinate, and a collective is a tensor move and a sum inside it (a mesh
of one card named N times, of distinct cards, of the CPU); a mesh of
``meta`` devices runs coordinate 0 alone (the dry run); a mesh bound to a
``torch.distributed`` process group runs one coordinate a process, and a
collective is the backend's ``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor`` or ``all_to_all_single`` over the group's
process group, through host memory where the mesh stages (gloo with CUDA
tensors). Each rank's counts are the one-process run's. This module is
the only place that knows how a collective is done.

``shard_model`` places a ``models.model.Model``'s parameters by their
logical axes under a rule table (a ``model.ShardedModel``);
``gather_model`` assembles a one-device ``Model`` from one.
"""
from __future__ import annotations

import dataclasses
import time
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


def local_coords(mesh) -> List[int]:
    """The coordinate indices this process runs, in the order of every
    per-coordinate list (a ``Sharded``'s shards, a collective's operands):
    every one in one process; on a mesh of ``meta`` devices (shapes, no
    values: the dry run) coordinate 0 alone, whose program is every
    coordinate's (``resolve`` gives every shard of a tensor one shape), so
    each collective shapes its result from coordinate 0's operand and
    counts what every device moves; on a mesh bound to a process group the
    rank's own. Entry i of such a list is coordinate
    ``local_coords(mesh)[i]``: a decision one coordinate takes from its
    spans is every coordinate's, since the shards are equal."""
    if mesh.rank is not None:
        return [mesh.rank]
    return [0] if mesh.device_list[0].type == "meta" else \
        list(range(mesh.size))


def local_devices(mesh) -> List[torch.device]:
    """The device of each coordinate this process runs."""
    return [mesh.device_list[c] for c in local_coords(mesh)]


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
    """One collective over every group; returns one tensor a coordinate the
    process runs, each its own (never another coordinate's object)."""
    g = group_size(mesh, axes)
    if mesh.rank is not None:           # one coordinate a process
        out = [_run_group(mesh, kind, axes, dims, xs[0], op)]
        _count(mesh, kind, g, out[0])
        return out
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


def _dist_call(names):
    """The first of ``names`` that this torch's ``torch.distributed`` has
    (a later torch renames ``all_gather_into_tensor`` and
    ``reduce_scatter_tensor``, and warns at the old names)."""
    import torch.distributed as dist
    return next(getattr(dist, n) for n in names if hasattr(dist, n))


def _run_group(mesh, kind: str, axes, dims, x: torch.Tensor, op: str
               ) -> torch.Tensor:
    """The rank's part of one collective over its group's process group.
    The process group orders its members by rank; the mesh's group order
    (``groups``) may differ, so parts are sent and read by each member's
    place in it. Under ``mesh.stage_on_host`` the operand goes to host
    memory and the result back."""
    import torch.distributed as dist
    grp = next(gr for gr in groups(mesh, axes) if mesh.rank in gr)
    ranks = sorted(grp)
    pg = mesh.groups[tuple(ranks)]
    g, dev, cost = len(grp), x.device, mesh.transport
    x = x.detach()
    if mesh.stage_on_host:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        x = x.to("cpu")
        cost["stage_s"] += time.perf_counter() - t0
        cost["staged_bytes"] += _bytes(x)
    t0 = time.perf_counter()
    if kind == "all-reduce":
        res = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(res, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=pg)
    elif kind == "all-gather":
        # the flat form every backend takes: the members' operands in turn
        got = x.new_empty((g,) + tuple(x.shape))
        _dist_call(("all_gather_single", "all_gather_into_tensor"))(
            got.view(-1), x.reshape(-1).contiguous(), group=pg)
        res = torch.cat([got[ranks.index(m)] for m in grp], dims[0])
    else:
        parts = x.chunk(g, dims[0])
        send = torch.stack([parts[grp.index(r)] for r in ranks])
        if kind == "reduce-scatter":
            res = x.new_empty(parts[0].shape)
            _dist_call(("reduce_scatter_single", "reduce_scatter_tensor"))(
                res.view(-1), send.view(-1), op=dist.ReduceOp.SUM, group=pg)
        else:                       # all-to-all: split dims[0], cat dims[1]
            got = torch.empty_like(send)
            dist.all_to_all_single(got, send, group=pg)
            res = torch.cat([got[ranks.index(m)] for m in grp], dims[1])
    cost["collective_s"] += time.perf_counter() - t0
    if not mesh.stage_on_host:
        return res.contiguous()
    t0 = time.perf_counter()
    res = res.to(dev).contiguous()
    torch.cuda.synchronize(dev)
    cost["stage_s"] += time.perf_counter() - t0
    cost["staged_bytes"] += _bytes(res)
    return res


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
    if len(xs) != len(local_coords(mesh)):
        raise ValueError(f"a collective takes one tensor a coordinate "
                         f"({len(local_coords(mesh))}), got {len(xs)}")
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
    ``shards[i]`` is the part of coordinate ``local_coords(mesh)[i]``, or
    None where the coordinate holds none (a layer's optimizer moments,
    owned by other data coordinates: ``train.optimizer.moment_layout``).
    Under a process group a rank holds its own shard alone."""
    mesh: object
    spec: sh.Spec
    shape: Tuple[int, ...]
    shards: List[torch.Tensor]

    def region(self, c: int) -> Tuple[slice, ...]:
        """The global region that coordinate ``c`` (of ``mesh.coords()``)
        holds."""
        coord, sizes = self.mesh.coords()[c], self.mesh.shape
        return tuple(sh.shard_slice(n, e, sizes, coord)
                     for n, e in zip(self.shape, self.spec))

    def slices(self, i: int) -> Tuple[slice, ...]:
        """The global region of ``shards[i]``."""
        return self.region(local_coords(self.mesh)[i])

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
    def full(self, device=None, *, root: Optional[int] = None
             ) -> Optional[torch.Tensor]:
        """The global tensor on ``device`` (default: the first coordinate
        the process runs). Under a process group every rank calls it: an
        all-gather of every coordinate's shard, or with ``root`` a gather
        to that rank alone, the others getting None (neither counted in
        ``mesh.collectives``). ``root`` means nothing in one process."""
        dev = local_devices(self.mesh)[0] if device is None else device
        if self.mesh.rank is not None:
            return self._gather_full(dev, root)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for i, t in enumerate(self.shards):
            if t is not None:
                out[self.slices(i)] = t.detach().to(dev)
        return out

    def _gather_full(self, dev, root: Optional[int]
                     ) -> Optional[torch.Tensor]:
        import torch.distributed as dist
        mesh, mine = self.mesh, self.shards[0]
        if mesh.size == 1:
            return mine.detach().to(dev, copy=True)
        pg = mesh.groups[tuple(range(mesh.size))]
        host = "cpu" if mesh.stage_on_host else local_devices(mesh)[0]
        # which coordinates hold a shard, and its dtype: a non-owner of a
        # layer's moments holds none and learns the dtype here
        code = torch.tensor([-1 if mine is None else _DTYPES.index(
            mine.dtype)], dtype=torch.int64, device=host)
        codes = code.new_empty(mesh.size)
        _dist_call(("all_gather_single", "all_gather_into_tensor"))(
            codes, code, group=pg)
        codes = codes.tolist()
        dtype = _DTYPES[max(codes)]
        shape = sh.shard_shape(self.shape, self.spec, mesh.shape)
        part = (torch.zeros(shape, dtype=dtype, device=host) if mine is None
                else mine.detach().to(host).contiguous())
        if root is None:
            got = part.new_empty((mesh.size,) + tuple(shape))
            _dist_call(("all_gather_single", "all_gather_into_tensor"))(
                got.view(-1), part.reshape(-1), group=pg)
        elif mesh.rank == root:
            got = list(part.new_empty((mesh.size,) + tuple(shape)))
            dist.gather(part, got, dst=root, group=pg)
        else:
            dist.gather(part, None, dst=root, group=pg)
            return None
        out = torch.empty(self.shape, dtype=dtype, device=dev)
        for c, held in enumerate(codes):
            if held >= 0:
                out[self.region(c)] = got[c].to(dev)
        return out


_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16,
           torch.int8, torch.uint8, torch.int32, torch.int64)


@torch.no_grad()
def place(t: torch.Tensor, mesh, spec: sh.Spec, *,
          parameter: bool = False) -> Sharded:
    """Cut ``t`` by ``spec`` onto ``mesh``'s devices (copies; as
    ``nn.Parameter`` leaves with ``parameter``)."""
    if len(spec) != t.ndim:
        raise ValueError(f"spec {spec} does not name the {t.ndim} dims of "
                         f"{tuple(t.shape)}")
    out = Sharded(mesh, tuple(spec), tuple(t.shape), [])
    for i, dev in enumerate(local_devices(mesh)):
        part = t[out.slices(i)].to(dev, copy=True).contiguous()
        out.shards.append(nn.Parameter(part) if parameter else part)
    return out


def zeros(shape, dtype, mesh, spec: sh.Spec) -> Sharded:
    """A zero ``Sharded`` of ``shape``."""
    loc = sh.shard_shape(shape, spec, mesh.shape)
    return Sharded(mesh, tuple(spec), tuple(shape),
                   [torch.zeros(loc, dtype=dtype, device=d)
                    for d in local_devices(mesh)])


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
    masks), on ``device`` (default: the first coordinate the process
    runs); under a process group every rank gathers it."""
    from .model import Model
    dev = local_devices(sharded.mesh)[0] if device is None else device
    model = Model(sharded.cfg, device=dev)
    for name, p in model.named_parameters():
        p.copy_(sharded.params[name].full(dev))
    for name, b in model.named_buffers():
        b.copy_(sharded.masks[name][0])
    return model


__all__ = ["KINDS", "Sharded", "all_gather", "all_reduce", "all_reduce_max",
           "all_to_all", "gather_model", "group_size", "groups",
           "local_coords", "local_devices", "place", "reduce_scatter",
           "shard_model", "zeros"]
