"""The LM train step (gradient accumulation over microbatches, remat,
AdamW) and the sparsity lifecycle's hook into a train loop.

The port of ``repro.train.trainer``, on one device: a step is eager torch
(no jit), there are no shardings and no donation (the step updates the
model's parameters and the optimizer's moments in place, which is what
JAX's donation buys).
``loss_and_grads`` runs the microbatches in order and sums their
gradients in f32; the step is ``train.optimizer.adamw_update`` (pruning
masks and norm scales take no weight decay). ``train/zero.py`` has no counterpart: its presets map
logical axes onto a device mesh, and one device has nothing to shard the
moments over.

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
from ..models.config import ModelConfig
from ..sparse import api
from ..sparse import pattern as spat
from .optimizer import AdamWConfig, adamw_init, adamw_update


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
    """``make_step_fn``'s step, with JAX ``build_train_step``'s signature
    less ``donate``. One device: nothing is jit-compiled, there are no
    shardings to derive from ``axes`` or the templates, and nothing to
    donate (the step always updates the parameters and moments in place,
    so it never holds two copies of them). ``zero1`` is accepted and does
    nothing: ZeRO-1 shards the moments over the data axis, and one device
    has none."""
    return make_step_fn(cfg, opt_cfg, n_micro=n_micro, remat=remat)


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


__all__ = ["build_train_step", "init_train_state", "loss_and_grads",
           "make_prune_callback", "make_step_fn"]
