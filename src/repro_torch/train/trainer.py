"""The sparsity lifecycle's hook into a train loop.

The port of ``repro.train.trainer.make_prune_callback``; the rest of that
module (the LM step functions) is not ported yet (ROADMAP queue 1 item
12). A re-prune changes the shape of a layer's values, so it runs on the
host between steps.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Optional

import torch

from ..sparse import api
from ..sparse import pattern as spat


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


__all__ = ["make_prune_callback"]
