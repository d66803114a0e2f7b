"""The LM train step (gradient accumulation over microbatches, remat,
AdamW) and the sparsity lifecycle's hook into a train loop.

The port of ``repro.train.trainer``: a step is eager torch (no jit) and
has no donation (the step updates the model's parameters and the
optimizer's moments in place, which is what JAX's donation buys).
``loss_and_grads`` runs the microbatches in order and sums their
gradients in f32; the step is ``train.optimizer.adamw_update`` (pruning
masks and norm scales take no weight decay).

On a mesh (``build_train_step`` inside ``models.sharding.axis_rules``)
the step takes a ``models.model.ShardedModel``:
``sharded_loss_and_grads`` (each coordinate's part of every gradient;
autograd reduce-scatters an FSDP weight's), ``reduce_grads`` (the parts
summed over each parameter's replicas, reduce-scattered onto the moments'
slices under ZeRO-1, ``train.zero``) and
``optimizer.sharded_adamw_update``; ``moment_specs`` places the moments
as JAX's tree does.

``make_prune_callback`` re-prunes every sparse ``Linear`` on a
``PruneSchedule``; a re-prune changes the shape of a layer's values, so
it runs on the host between steps.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..kernels.ops import resolve_device
from ..models import model as M
from ..models import sharding as sh
from ..models import spmd
from ..models.config import ModelConfig
from ..sparse import api
from ..sparse import pattern as spat
from . import optimizer
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .zero import zero1_axes


def _on_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _value_and_grad(model: M.Model, batch, remat: bool
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The loss and d loss / d p for every parameter of ``model`` in
    ``named_parameters()`` order; a parameter the loss does not reach
    gets zeros, as ``jax.grad`` gives it."""
    params = list(model.parameters())
    loss = M.loss_fn(model, batch, remat=remat)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(params, grads)]


def loss_and_grads(model: M.Model, batch: Dict[str, Any], *,
                   n_micro: int = 1, remat: bool = True
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean loss and grads ``{name: grad}`` over ``n_micro``
    microbatches (JAX ``trainer.loss_and_grads``): with ``n_micro > 1``
    the batch's leading dim is split into ``n_micro`` equal slices, run in
    order, their losses and f32 grads summed and scaled by
    ``1 / n_micro``. A batch that does not divide raises ``ValueError``.
    The parameters' ``.grad`` are not touched."""
    names = [n for n, _ in model.named_parameters()]
    batch = _on_device(batch, model.device)
    if n_micro == 1:
        loss, grads = _value_and_grad(model, batch, remat)
        return loss, dict(zip(names, grads))
    for x in batch.values():
        if x.shape[0] % n_micro != 0:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"n_micro={n_micro}")
    loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in model.parameters()]
    for i in range(n_micro):
        mb = {k: x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])[i]
              for k, x in batch.items()}
        loss, grads = _value_and_grad(model, mb, remat)
        gsum = [a + g.to(torch.float32) for a, g in zip(gsum, grads)]
        loss_sum = loss_sum + loss
        del grads
    inv = 1.0 / n_micro
    return loss_sum * inv, {n: g * inv for n, g in zip(names, gsum)}


def make_step_fn(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                 n_micro: int = 1, remat: bool = True):
    """``step(model, opt_state, batch) -> (model, opt_state, metrics)``:
    ``loss_and_grads`` then ``adamw_update``, which writes the parameters
    and ``opt_state`` in place; metrics ``loss``, ``grad_norm``, ``lr``
    (0-d tensors on the model's device)."""
    def step(model: M.Model, opt_state: Dict[str, Any], batch):
        if model.cfg != cfg:
            raise ValueError(f"the step was built for {cfg.name}, the model "
                             f"is {model.cfg.name}")
        loss, grads = loss_and_grads(model, batch, n_micro=n_micro,
                                     remat=remat)
        _, opt_state, metrics = adamw_update(
            opt_cfg, grads, opt_state, dict(model.named_parameters()))
        return model, opt_state, dict(metrics, loss=loss)
    return step


def build_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, axes=None, *,
                     n_micro: int = 1, remat: bool = True,
                     zero1: bool = True,
                     params_template=None, opt_template=None):
    """The train step, with JAX ``build_train_step``'s signature less
    ``donate`` (the step updates the parameters and moments in place, so
    it never holds two copies of them; nothing is jit-compiled).

    Outside ``sharding.axis_rules``: ``make_step_fn``'s one-device step.
    Inside: the step of a ``ShardedModel`` placed on that mesh under those
    rules, ``step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: ``sharded_loss_and_grads``, ``reduce_grads`` (replicated
    parameters' gradients all-reduced over their replica axes; under
    ZeRO-1 reduce-scattered over "data" onto the moments' slices), then
    ``optimizer.sharded_adamw_update``. The moments are placed by
    ``moment_specs``: ``opt_state_axes`` of ``axes`` (default
    ``init_axes(cfg)``), reshaped by ``zero1_axes`` when ``zero1`` and the
    moments are f32 (JAX's rule); build the state with
    ``init_sharded_opt_state``. ``params_template`` / ``opt_template``
    (trees with ``.shape``) are JAX's divisibility templates: given, their
    shapes must be the model's."""
    mesh = sh.current_mesh()
    if mesh is None:
        return make_step_fn(cfg, opt_cfg, n_micro=n_micro, remat=remat)
    rules = sh.current_rules()
    axes = M.init_axes(cfg) if axes is None else axes

    def step(model: M.ShardedModel, opt_state: Dict[str, Any], batch):
        if model.cfg != cfg or model.mesh is not mesh or \
                model.rules != rules:
            raise ValueError("the step was built for another config, mesh "
                             "or rule table than the model's")
        for tmpl in (params_template,
                     None if opt_template is None else opt_template["m"]):
            if tmpl is not None and any(
                    tuple(getattr(tmpl[k], "shape", ())) != p.shape
                    for k, p in model.params.items()
                    if not isinstance(tmpl[k], dict)):
                raise ValueError("a template's shapes are not the model's")
        mspecs = moment_specs(opt_cfg, model, zero1=zero1, axes=axes)
        loss, grads = sharded_loss_and_grads(model, batch, n_micro=n_micro,
                                             remat=remat)
        grads = reduce_grads(model, grads, mspecs)
        _, opt_state, metrics = optimizer.sharded_adamw_update(
            opt_cfg, grads, opt_state, model, mspecs)
        return model, opt_state, dict(metrics, loss=loss)
    return step


def moment_specs(opt_cfg: AdamWConfig, model: M.ShardedModel, *,
                 zero1: bool = True, axes=None) -> Dict[str, Any]:
    """{name: spec} of each parameter's moments (int8: {"q": spec, "s":
    spec}, each resolved with its own shape) under the model's rules:
    ``moment_specs_of`` for one layer's tensors (``per_layer``)."""
    return per_layer(moment_specs_of(
        opt_cfg, M.init_axes(model.cfg) if axes is None else axes,
        {k: p.shape for k, p in model.params.items()}, model.rules,
        model.mesh.shape, zero1=zero1, n_groups=model.cfg.n_groups))


def _block(name: str) -> bool:
    return name.startswith("blocks.")


def moment_specs_of(opt_cfg: AdamWConfig, axes, shapes, rules, sizes, *,
                    zero1: bool = True, n_groups: int = 1
                    ) -> Dict[str, Any]:
    """The moments' specs from parameter axes and shapes ({name: ...}), a
    rule table and mesh sizes, as JAX's tree has them: a block parameter
    (``blocks.*``) is one layer of JAX's stack of ``n_groups``, so its
    axes take JAX's leading ``"layers"`` and its shape ``n_groups`` before
    them, and its spec keeps that leading entry. ``opt_state_axes``, then
    ``zero1_axes`` for f32 moments when ``zero1`` (JAX turns ZeRO-1 off
    for int8 moments): for a block parameter the "fsdp" axis lands on
    "layers" or nowhere, so ZeRO-1 reshards only the embedding, the head
    and the final norm within a layer's tensors (``per_layer``)."""
    saxes = {k: ("layers",) + tuple(ax) if _block(k) else tuple(ax)
             for k, ax in axes.items()}
    oaxes = optimizer.opt_state_axes(opt_cfg, saxes)["m"]
    if zero1 and not opt_cfg.quantize:
        oaxes = zero1_axes(oaxes, rules)

    def spec(ax, shape):
        return sh.resolve_with(rules, sizes, ax, tuple(shape))
    out = {}
    for name, shape in shapes.items():
        shape = ((n_groups,) if _block(name) else ()) + tuple(shape)
        ax = oaxes[name]
        out[name] = ({"q": spec(ax["q"], shape),
                      "s": spec(ax["s"], optimizer.scale_shape(shape))}
                     if opt_cfg.quantize else spec(ax, shape))
    return out


def per_layer(specs: Dict[str, Any]) -> Dict[str, Any]:
    """``moment_specs_of``'s specs of one layer's tensors: a block
    parameter's leading "layers" entry dropped (where JAX shards the stack
    over "data", each layer's moments stay whole: the port does not place
    layers on coordinates; ROADMAP queue 1)."""
    def drop(name, sp):
        if isinstance(sp, dict):
            return {k: drop(name, v) for k, v in sp.items()}
        return sp[1:] if _block(name) else sp
    return {k: drop(k, v) for k, v in specs.items()}


def init_sharded_opt_state(opt_cfg: AdamWConfig, model: M.ShardedModel, *,
                           zero1: bool = True, axes=None) -> Dict[str, Any]:
    """The zero AdamW state of a ``ShardedModel`` placed by
    ``moment_specs`` (what ``build_train_step``'s sharded step takes)."""
    return optimizer.sharded_adamw_init(
        opt_cfg, model, moment_specs(opt_cfg, model, zero1=zero1, axes=axes))


def sharded_loss_and_grads(model: M.ShardedModel, batch: Dict[str, Any], *,
                           n_micro: int = 1, remat: bool = True):
    """``loss_and_grads`` over the mesh: the mean loss (coordinate 0's
    copy) and, for every parameter, one gradient a coordinate (with
    ``n_micro > 1`` summed in f32 over the microbatches and scaled by 1 /
    ``n_micro``). Each is the
    coordinate's part: a replicated parameter's true gradient is the sum
    over its replicas (``reduce_grads``). A microbatch is a slice of the
    global batch's rows, then split over the batch axes."""
    names = list(model.params)
    leaves = model.leaves()
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    for x in batch.values():
        if x.shape[0] % n_micro != 0:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"n_micro={n_micro}")
    dev0 = model.mesh.device_list[0]
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev0)
    gsum = None
    for i in range(n_micro):
        mb = {k: x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])[i]
              for k, x in batch.items()}
        losses = M.sharded_loss(model, mb, remat=remat)
        # the loss is replicated: the mean of its copies has its gradient
        objective = sum(t.to(dev0) for t in losses) / len(losses)
        grads = torch.autograd.grad(objective, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if gsum is None:
            gsum = grads if n_micro == 1 else [g.to(torch.float32)
                                               for g in grads]
        else:
            gsum = [a + g.to(torch.float32) for a, g in zip(gsum, grads)]
        loss_sum = loss_sum + losses[0].detach().to(dev0)
        del grads, losses, objective
    inv = 1.0 / n_micro
    if n_micro > 1:
        gsum = [g * inv for g in gsum]
    per = len(leaves) // len(names)
    return loss_sum * inv, {k: gsum[j * per:(j + 1) * per]
                            for j, k in enumerate(names)}


def reduce_grads(model: M.ShardedModel, grads, mspecs) -> Dict[str, list]:
    """Each parameter's gradient parts summed over its replicas, into the
    moments' layout: reduce-scattered over the axes the moments shard and
    the parameter does not (ZeRO-1), all-reduced over the rest of its
    replica axes (for a parameter replicated over "data", the data-parallel
    reduction)."""
    mesh, out = model.mesh, {}
    for name, gs in grads.items():
        p = model.params[name]
        spec_m = optimizer._grad_spec(mspecs[name])
        used = {a for e in p.spec for a in sh.axes_of(e)}
        scattered = set()
        for d, (pe, me) in enumerate(zip(p.spec, spec_m)):
            if pe != me:
                gs = spmd.reduce_scatter(gs, mesh, sh.axes_of(me), d)
                scattered.update(sh.axes_of(me))
        rest = [a for a in mesh.axis_names
                if a not in used and a not in scattered]
        out[name] = spmd.all_reduce(gs, mesh, rest)
    return out


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                     seed: int = 0, device=None
                     ) -> Tuple[M.Model, Dict[str, Any]]:
    """A model with weights from ``seed`` on ``device`` (default CUDA)
    and its zero AdamW state."""
    model = M.init(cfg, seed=seed, device=resolve_device(device))
    return model, adamw_init(opt_cfg, dict(model.named_parameters()))


def make_prune_callback(schedule: spat.PruneSchedule, *,
                        policy: str = "magnitude"):
    """Build a ``(step, model, opt_state) -> info | None`` hook that
    re-prunes every ``sparse.Linear`` of ``model`` (found through
    ``model.named_modules()``) to ``schedule.density_at(step)`` whenever
    ``schedule.due(step)``. ``policy`` is ``"magnitude"`` (default) or a
    structured ``"n:m"`` string like ``"2:4"`` (the schedule then only
    gates WHEN; the density is n/m).

    For each layer whose selection moves: the layer's ``meta`` and its
    ``values`` ``Parameter`` are replaced in place, so its name in
    ``named_parameters()`` stays (``l1.values``); values surviving the
    pattern change carry over and new slots start at 0. The AdamW moments
    ``opt_state["m"][name]`` and ``["v"][name]`` (``train.optimizer``) are
    repacked onto the new layout: surviving slots keep their moments, new
    slots start at 0. A caller that holds ``dict(model.named_parameters())``
    takes it again after a step that returned ``info``: the old tensors
    are no longer the model's.

    Int8 moments cannot be repacked (their per-block scales do not
    survive a slot remap) and raise. Stacked per-stage values are skipped
    with a one-time warning. ``info`` is None when nothing changed (the
    model and state are untouched), else ``{"step", "density", "layers",
    "nnz"}``.
    """
    if policy != "magnitude":
        spat.parse_nm(policy)                   # fail at build, not step N
    warned_stacked = [False]

    def callback(step: int, model: torch.nn.Module,
                 opt_state: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        if not schedule.due(step):
            return None
        density = schedule.density_at(step)
        changed, nnz = 0, 0
        for mod_name, lin in list(model.named_modules()):
            if not isinstance(lin, api.Linear):
                continue
            node = lin.inner
            if spat.is_stacked_node(node):
                if not warned_stacked[0]:
                    warned_stacked[0] = True
                    warnings.warn(
                        f"prune callback: skipping stacked per-stage "
                        f"values of {type(node).__name__} — pipeline "
                        f"stacks share ONE pattern and cannot be "
                        f"re-pruned in place; re-prune the stages "
                        f"individually before stacking, or keep stacked "
                        f"layers off the schedule", stacklevel=2)
                continue
            if not spat.is_lifecycle_node(node):
                continue
            new_node = spat.magnitude_repack(node, density, policy=policy)
            if new_node is node:
                continue
            name = f"{mod_name}.values" if mod_name else "values"
            moments = [opt_state[k][name] for k in ("m", "v")]
            if not all(isinstance(x, torch.Tensor) for x in moments):
                raise ValueError(
                    "prune callback needs plain (unquantized) moments; got "
                    f"{type(moments[0]).__name__} for {name}")
            for k, x in zip(("m", "v"), moments):
                opt_state[k][name] = spat.repack_onto(
                    type(node)(x, node.meta), new_node).values
            lin.set_inner(new_node)
            changed += 1
            nnz += spat.get_pattern(new_node).nnz
        if not changed:
            return None
        return {"step": step, "density": density, "layers": changed,
                "nnz": nnz}
    return callback


__all__ = ["build_train_step", "init_sharded_opt_state", "init_train_state",
           "loss_and_grads", "make_prune_callback", "make_step_fn",
           "moment_specs", "moment_specs_of", "per_layer", "reduce_grads",
           "sharded_loss_and_grads"]
