"""AdamW with optional int8-quantized moments, as plain functions.

The port of ``repro.train.optimizer``. Parameters, gradients and moments
are mappings from a name to a tensor (``dict(model.named_parameters())``
and the matching gradients); the update runs under ``torch.no_grad()``
and writes each parameter in place. The state is

  {"m": {name: m}, "v": {name: v}, "count": 0-d int32 tensor}

with f32 moments, or with ``quantize=True`` blockwise-int8 moments
``{"q": int8 payload of the parameter's shape, "s": f32 scales}`` (v is
stored in the square-root domain), which ``adamw_update`` updates in
place. Names with a part (between dots) starting ``mask_`` or ``norm``
take no weight decay. The arithmetic is
the JAX package's, in f32, step for step.

``opt_state_axes`` gives the state's logical axes (JAX's).
``sharded_adamw_init`` and ``sharded_adamw_update`` are the same
optimizer over a device mesh (``models.spmd``): each coordinate holds the
moments its spec gives it and updates its slice of the parameter; the
clipping norm counts each shard once; int8 moments keep JAX's blocks
along the last dim even where a shard boundary cuts one (the block
maxima are all-reduced over the axes that cut it), so every bit of the
state is the one-device state's for the same gradients.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Tuple

import torch

from ..models import sharding as sh
from ..models import spmd

QBLOCK = 256        # quantization block (per flattened chunk)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize: bool = False       # int8 moments
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac (f32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


# ----------------------------------------------------------------------
# int8 moments. The payload keeps the parameter's exact shape; scales are
# blockwise along the last dim when it divides QBLOCK, else per row.
def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    last = x.shape[-1] if x.ndim else 1
    if x.ndim and last % QBLOCK == 0:
        xb = x.reshape(*x.shape[:-1], last // QBLOCK, QBLOCK)
        scale = xb.abs().amax(dim=-1) / 127.0 + 1e-12
        q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127)
        q = q.reshape(x.shape).to(torch.int8)
    else:
        scale = (x.abs().amax(dim=-1, keepdim=True) if x.ndim
                 else x.abs()) / 127.0 + 1e-12
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequant(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    shape = tuple(shape)
    last = shape[-1] if len(shape) else 1
    if len(shape) and last % QBLOCK == 0 and \
            scale.shape[-1] == last // QBLOCK:
        qb = q.to(torch.float32).reshape(*shape[:-1], last // QBLOCK,
                                         QBLOCK)
        return (qb * scale[..., None]).reshape(shape)
    return q.to(torch.float32) * scale


# ----------------------------------------------------------------------
def _decays(name: str) -> bool:
    """No weight decay on pruning masks (fixed metadata) or norm scales."""
    return not any(part.startswith(("mask_", "norm"))
                   for part in name.split("."))


def adamw_init(cfg: AdamWConfig,
               params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Zero moments for every named parameter, on its device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def moment(p):
        if cfg.quantize:
            q, s = _quant(zeros(p))
            return {"q": q, "s": s}
        return zeros(p)
    device = next(iter(params.values())).device if params else "cpu"
    return {"m": {k: moment(p) for k, p in params.items()},
            "v": {k: moment(p) for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in tensors.values()))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor],
                 state: Dict[str, Any],
                 params: Mapping[str, torch.Tensor]):
    """One AdamW step, in place: writes each parameter and updates
    ``state`` (f32 moments in their tensors, int8 ones replaced entry by
    entry, the count), so the old and the new moments never exist whole
    at once. Returns ``(params, state, metrics)`` with metrics
    ``grad_norm`` and ``lr``."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, state["count"])
    bc1, bc2 = _bias_corrections(cfg, count)
    for name, p in params.items():
        g = grads[name].to(torch.float32) * clip
        m, v = state["m"][name], state["v"][name]
        if cfg.quantize:
            mf = _dequant(m["q"], m["s"], g.shape)
            # v is stored in the sqrt domain (halves the dynamic range a
            # linear int8 grid must cover)
            vf = torch.square(_dequant(v["q"], v["s"], g.shape))
        else:
            mf, vf = m, v
        _adam_step(cfg, name, g, mf, vf, p, lr, bc1, bc2)
        if cfg.quantize:
            mq, ms = _quant(mf)
            vq, vs = _quant(torch.sqrt(vf))
            state["m"][name] = {"q": mq, "s": ms}
            state["v"][name] = {"q": vq, "s": vs}
        # this parameter's temporaries go before the next one's are made
        del g, mf, vf
    state["count"] = count
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _bias_corrections(cfg: AdamWConfig, count: torch.Tensor):
    return (1 - torch.pow(cfg.b1, count.to(torch.float32)),
            1 - torch.pow(cfg.b2, count.to(torch.float32)))


def _adam_step(cfg: AdamWConfig, name: str, g, mf, vf, p, lr, bc1,
               bc2) -> None:
    """One parameter's AdamW step, in place on ``mf``, ``vf`` and ``p``
    (f32 clipped gradient ``g``)."""
    b1, b2 = cfg.b1, cfg.b2
    mf.mul_(b1).add_((1 - b1) * g)
    vf.mul_(b2).add_((1 - b2) * g * g)
    mhat = mf / bc1
    vhat = vf / bc2
    upd = mhat / (torch.sqrt(vhat) + cfg.eps)
    if cfg.quantize:
        # quantization can zero tiny v entries, which would turn |m / eps|
        # into a 1e8x step
        upd = torch.clamp(upd, -3.0, 3.0)
    wd = cfg.weight_decay if _decays(name) else 0.0
    step = upd + wd * p.to(torch.float32)
    p.copy_((p.to(torch.float32) - lr * step).to(p.dtype))


def opt_state_axes(cfg: AdamWConfig, param_axes):
    """Logical axes of the optimizer state (JAX ``opt_state_axes``): the
    moments inherit each parameter's axes (``train.zero`` may reshard them
    over data); an int8 moment's payload keeps the parameter's shape and
    its scales its number of dims (last dim / QBLOCK or 1), so both take
    the same axes, resolved with their own shapes."""
    def mom(ax):
        return {"q": ax, "s": ax} if cfg.quantize else ax
    return {"m": sh.map_axes(mom, param_axes),
            "v": sh.map_axes(mom, param_axes), "count": ()}


# ----------------------------------------------------------------------
# The sharded AdamW (``models.spmd``): each coordinate updates the slice of
# each parameter that its moments hold; the gradients come in reduced, in
# the moments' layout (``trainer.reduce_grads``).
def scale_shape(shape) -> Tuple[int, ...]:
    """The shape of an int8 moment's scales (``_quant``)."""
    shape = tuple(shape)
    if not shape:
        return ()
    last = shape[-1]
    return shape[:-1] + ((last // QBLOCK,) if last % QBLOCK == 0 else (1,))


def sharded_adamw_init(cfg: AdamWConfig, model, mspecs
                       ) -> Dict[str, Any]:
    """Zero moments of a ``ShardedModel`` placed by ``mspecs`` ({name:
    spec}, or {name: {"q": spec, "s": spec}} for int8 moments); the count
    on the first coordinate's device."""
    mesh = model.mesh

    def moment(name, p):
        spec = mspecs[name]
        if cfg.quantize:
            q = spmd.zeros(p.shape, torch.int8, mesh, spec["q"])
            s = spmd.zeros(scale_shape(p.shape), torch.float32, mesh,
                           spec["s"])
            for t in s.shards:
                t.fill_(1e-12)          # _quant's scale of zeros
            return {"q": q, "s": s}
        return spmd.zeros(p.shape, torch.float32, mesh, spec)
    return {"m": {k: moment(k, p) for k, p in model.params.items()},
            "v": {k: moment(k, p) for k, p in model.params.items()},
            "count": torch.zeros((), dtype=torch.int32,
                                 device=mesh.device_list[0])}


def _counts_in_norm(mesh, coord: Dict[str, int], spec) -> bool:
    """Whether coordinate ``coord`` counts its shard of a tensor placed by
    ``spec`` in the global norm: once a shard, at the first replica."""
    used = {a for e in spec for a in sh.axes_of(e)}
    return all(coord[a] == 0 for a in mesh.axis_names if a not in used)


def _grad_spec(spec):
    return spec["q"] if isinstance(spec, dict) else spec


def sharded_global_norm(model, grads, mspecs) -> List[torch.Tensor]:
    """The global norm of reduced gradients, each shard counted once
    (replicas not again), all-reduced over the mesh: one copy a
    coordinate."""
    mesh = model.mesh
    parts = []
    n = spmd.n_coords(mesh)
    for i, (coord, dev) in enumerate(zip(mesh.coords()[:n],
                                         mesh.device_list[:n])):
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for name, gs in grads.items():
            if _counts_in_norm(mesh, coord, _grad_spec(mspecs[name])):
                total = total + torch.sum(torch.square(
                    gs[i].to(torch.float32)))
        parts.append(total)
    return [torch.sqrt(t) for t in
            spmd.all_reduce(parts, mesh, mesh.axis_names)]


def _region(p, spec_m, i) -> Tuple[slice, ...]:
    """Coordinate i's slice of its parameter shard that its moments (spec
    ``spec_m``) hold."""
    out = []
    coord, sizes = p.mesh.coords()[i], p.mesh.shape
    for d, (pe, me) in enumerate(zip(p.spec, spec_m)):
        if pe == me:
            out.append(slice(None))
        elif pe is None:
            out.append(sh.shard_slice(p.shape[d], me, sizes, coord))
        else:
            raise ValueError(f"moment spec {spec_m} does not refine the "
                             f"parameter's {p.spec}")
    return tuple(out)


def _dequant_shard(q, s, i) -> torch.Tensor:
    """Coordinate i's f32 moment from its int8 payload and JAX's block
    scales (held whole along the last dim where a shard cuts a block)."""
    qi, si = q.shards[i], s.shards[i]
    if not sh.axes_of(q.spec[-1]) or s.spec[-1] == q.spec[-1]:
        return _dequant(qi, si, qi.shape)
    if q.shape[-1] % QBLOCK:
        return qi.to(torch.float32) * si
    c0, c1 = q.span(i, len(q.shape) - 1)
    ids = torch.arange(c0, c1, device=qi.device) // QBLOCK
    return qi.to(torch.float32) * si[..., ids]


def _requant_sharded(mfs, q, s) -> None:
    """Quantize each coordinate's f32 moment into ``q`` and ``s`` in
    place, JAX's blocks along the last dim: where a shard cuts a block (or
    a row's one scale), the block maxima are all-reduced (max) over the
    axes that split it, so every bit is the one-device quantization's."""
    last = len(q.shape) - 1
    axes = sh.axes_of(q.spec[last]) if q.shape else ()
    if not axes or s.spec[-1] == q.spec[-1]:
        for i, mf in enumerate(mfs):
            qi, si = _quant(mf)
            q.shards[i].copy_(qi)
            s.shards[i].copy_(si)
        return
    blocked = q.shape[-1] % QBLOCK == 0
    amax, ids = [], []
    for i, mf in enumerate(mfs):
        c0, c1 = q.span(i, last)
        a = mf.abs()
        if blocked:
            idx = (torch.arange(c0, c1, device=mf.device) // QBLOCK
                   ).expand_as(a)
            amax.append(torch.zeros(*a.shape[:-1], q.shape[-1] // QBLOCK,
                                    dtype=torch.float32, device=mf.device
                                    ).scatter_reduce(-1, idx, a, "amax"))
            ids.append(idx[(0,) * (a.ndim - 1)])
        else:
            amax.append(a.amax(dim=-1, keepdim=True))
    amax = spmd.all_reduce_max(amax, q.mesh, axes)
    for i, (mf, am) in enumerate(zip(mfs, amax)):
        scale = am / 127.0 + 1e-12
        el = scale[..., ids[i]] if blocked else scale
        q.shards[i].copy_(torch.clamp(torch.round(mf / el), -127, 127
                                      ).to(torch.int8))
        s.shards[i].copy_(scale)


@torch.no_grad()
def sharded_adamw_update(cfg: AdamWConfig, grads, state: Dict[str, Any],
                         model, mspecs):
    """``adamw_update`` over the mesh: ``grads`` {name: one reduced
    gradient a coordinate, in the moments' layout}; each coordinate
    updates its moments and its slice of the parameter, and where the
    moments are sharded finer than the parameter (ZeRO-1) the updated
    slices are all-gathered back into every replica. The clipping norm
    counts each shard once. int8 moments keep JAX's blocks
    (``_requant_sharded``). Returns ``(model, state, metrics)``."""
    mesh = model.mesh
    count = state["count"] + 1
    gnorm = sharded_global_norm(model, grads, mspecs)
    lr = lr_at(cfg, state["count"])
    bc1, bc2 = _bias_corrections(cfg, count)
    for name, p in model.params.items():
        spec_m = _grad_spec(mspecs[name])
        m, v = state["m"][name], state["v"][name]
        subs, mfs, vfs = [], [], []
        for i, pl in enumerate(p.shards):
            dev = pl.device
            clip = torch.clamp(cfg.grad_clip / (gnorm[i] + 1e-9), max=1.0)
            g = grads[name][i].to(torch.float32) * clip
            sub = pl[_region(p, spec_m, i)]
            if cfg.quantize:
                mf = _dequant_shard(m["q"], m["s"], i)
                vf = torch.square(_dequant_shard(v["q"], v["s"], i))
            else:
                mf, vf = m.shards[i], v.shards[i]
            _adam_step(cfg, name, g, mf, vf, sub, lr.to(dev), bc1.to(dev),
                       bc2.to(dev))
            subs.append(sub)
            mfs.append(mf)
            vfs.append(vf)
        if cfg.quantize:
            _requant_sharded(mfs, m["q"], m["s"])
            _requant_sharded([torch.sqrt(x) for x in vfs], v["q"], v["s"])
        for d, (pe, me) in enumerate(zip(p.spec, spec_m)):
            if pe != me:
                subs = spmd.all_gather(subs, mesh, sh.axes_of(me), d)
        if any(pe != me for pe, me in zip(p.spec, spec_m)):
            for pl, full in zip(p.shards, subs):
                pl.copy_(full)
        del subs, mfs, vfs
    state["count"] = count
    return model, state, {"grad_norm": gnorm[0], "lr": lr}
