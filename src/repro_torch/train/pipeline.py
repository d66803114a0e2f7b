"""GPipe-style pipeline over the stages of a ``launch.mesh.Mesh``.

The port of ``repro.train.pipeline`` for one controlling process, as the
row-sharded path drives its mesh (``launch/mesh.py``): stage ``i`` holds
its slice of the stacked parameters on mesh device ``i`` along the pipe
axis (one card may be named several times), and this process launches
the stages in GPipe's order: time step ``t`` runs stage ``s`` on
microbatch ``t - s`` (fill, steady state, drain: ``n_micro + n_stages -
1`` steps), each stage's output moved to the next stage's device. JAX
runs the same schedule under ``shard_map`` with ``ppermute``; here the
stages of one time step are issued one after another.

The pipeline is differentiable: gradients come from autograd through the
same launches (a stage's backward runs where its forward ran), so the
InCRS stages' backward launches the fused kernel for dx on the
transposed stripes and forms dW in torch ops (``sparse.linear``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from ..kernels import ops
from ..sparse import api
from ..sparse import linear as lin
from ..sparse import pattern as spat


def _meta_on(meta: Any, device: torch.device, cache: Dict) -> Any:
    """``linear.meta_to(meta, device)``, one copy a device per call."""
    key = (id(meta), device)
    if key not in cache:
        cache[key] = lin.meta_to(meta, device)
    return cache[key]


def _stage_slice(tree: Any, i: int, device: torch.device,
                 cache: Dict) -> Any:
    """Stage ``i``'s parameters on ``device``: index ``i`` of every leaf's
    leading stage axis (a stacked sparse node's values; its meta is
    shared by every stage). The slices are views, so their gradients
    reach the stacked leaf."""
    if isinstance(tree, api.Linear):
        tree = tree.inner
    if type(tree) in spat._FAMILIES:
        if not spat.is_stacked_node(tree):
            raise ValueError(f"a {type(tree).__name__} stage parameter must "
                             f"be a stack (sparse.stack_init)")
        return dataclasses.replace(tree, values=tree.values[i].to(device),
                                   meta=_meta_on(tree.meta, device, cache))
    if isinstance(tree, torch.Tensor):
        return tree[i].to(device)
    if isinstance(tree, dict):
        return {k: _stage_slice(v, i, device, cache) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stage_slice(v, i, device, cache) for v in tree)
    raise TypeError(f"cannot slice a stage out of a {type(tree).__name__}")


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   n_stages: int, n_micro: int, mesh, axis: str = "pipe"
                   ) -> torch.Tensor:
    """Run ``x`` through ``n_stages`` sequential stages on ``mesh``.

    stage_fn      : (params_one_stage, h) -> h, one shape in and out
    stage_params  : a tree whose leaves carry a leading stage axis of
                    ``n_stages`` (tensors, ``sparse.stack_init`` stacks)
    x             : (n_micro, mb, ...) microbatched input

    Stage ``i`` runs on device ``i`` of ``mesh`` along ``axis`` (which
    must have ``n_stages`` devices). Returns the last stage's outputs
    (n_micro, mb, ...) on x's device."""
    axes, n_dev = ops.shard_axes(mesh, axis)
    if n_dev != n_stages:
        raise ValueError(f"{n_stages} stages need a mesh of as many devices "
                         f"along {axes}, got {n_dev}")
    if x.shape[0] != n_micro:
        raise ValueError(f"x's leading dim {x.shape[0]} is not "
                         f"n_micro={n_micro}")
    devices = ops.shard_devices(mesh, axes)
    cache: Dict = {}
    params = [_stage_slice(stage_params, i, devices[i], cache)
              for i in range(n_stages)]
    h = [None] * n_stages           # h[s]: stage s's latest output
    outs = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        # last stage first, so each stage reads its predecessor's output
        # of the previous time step before it is overwritten
        for s in reversed(range(n_stages)):
            m = t - s
            if not 0 <= m < n_micro:
                continue
            inp = x[m] if s == 0 else h[s - 1]
            h[s] = stage_fn(params[s], inp.to(devices[s]))
            if s == n_stages - 1:
                outs[m] = h[s].to(x.device)
    return torch.stack(outs)


def split_stages(stacked_params, n_stages: int):
    """Reshape layer-stacked params (n_groups, ...) into (n_stages,
    groups_per_stage, ...) for the pipeline executor."""
    def r(a):
        if isinstance(a, dict):
            return {k: r(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(r(v) for v in a)
        g = a.shape[0]
        if g % n_stages != 0:
            raise ValueError(f"{g} layer groups do not divide into "
                             f"{n_stages} pipeline stages")
        return a.reshape(n_stages, g // n_stages, *a.shape[1:])
    return r(stacked_params)


def incrs_stage_fn(act: Callable = torch.tanh) -> Callable:
    """Stage function over a shared-pattern stack (``sparse.stack_init``):
    each stage applies its InCRS slice through ``sparse.api.apply`` (the
    fused kernel forward, and its autograd function's dx kernel backward)
    followed by ``act``. Only the values carry a stage axis; the stripe
    metadata is shared by every stage."""
    def stage(params_one_stage, h):
        return act(api.apply(params_one_stage, h))
    return stage


__all__ = ["incrs_stage_fn", "pipeline_apply", "split_stages"]
