"""ZeRO-1 over the layer stack: JAX's ``zero1_axes`` puts "fsdp" (= data)
on a block parameter's stacked-layers axis, so where ``n_groups`` divides
"data" each data coordinate owns whole layers' moments (contiguous groups
of ``n_groups / |data|``), and only the owners hold them and update the
layer.

Held here: every coordinate's moment bytes equal to the dry run's priced
AdamW bytes (``launch.dryrun.mesh_bytes``) for the same config, rules and
mesh; a non-owner holds no moment of a layer (``None``, not zeros); the
reduced gradients land on the owners alone; where ``n_groups`` does not
divide "data", and for int8 moments, every coordinate holds every layer
(the layout before layers were owned). Three f32 steps under ZeRO-1 without FSDP on (data 2,
model 4) against the same steps in the layout that keeps every layer on
every data coordinate (``trainer.per_layer``): the first step's loss is
bitwise, and so is every parameter after the first step whose replicas
are data alone (its reduction is one sum over "data" in the same order,
an all-reduce then or a reduce-scatter now); a parameter replicated over
"model" too (the norms' scales) sums over "data" first and "model" next
where the all-reduce summed the eight parts in one pass, so its gradient
moves by f32 rounding and the later steps follow it: the parameters after
three steps within 1e-5 of max|p|, the losses rtol 1e-6. JAX's one-device
step holds the owned layout in ``tests/test_torch_lm_sharded_jax_
overrides.py`` (``granite_zero1``).
"""
from __future__ import annotations

import dataclasses

import pytest
from _threads import one_thread                          # noqa: F401
import torch
from _sharded_lm import batch, cfg_of, init, mesh

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun
from repro_torch.models import sharding as sh
from repro_torch.models import spmd
from repro_torch.train import optimizer as O
from repro_torch.train import trainer as T
from repro_torch.train.zero import FSDP_OVERRIDES

OPT = O.AdamWConfig(lr=1e-3, warmup_steps=0)


def _moment_bytes(state, i):
    n = 0
    for kind in ("m", "v"):
        for x in state[kind].values():
            for t in (x.values() if isinstance(x, dict) else (x,)):
                if t.shards[i] is not None:
                    n += t.shards[i].numel() * t.shards[i].element_size()
    return n + state["count"].numel() * state["count"].element_size()


@pytest.mark.parametrize("arch,layers,shape,rules", [
    ("granite-34b", 4, (2, 4), None),
    ("granite-34b", 4, (4, 2), None),
    ("mamba2-370m", 4, (2, 4), FSDP_OVERRIDES),
    ("recurrentgemma-2b", 6, (2, 4), None),
    ("mixtral-8x7b", 2, (2, 2, 2), None),
    ("granite-34b", 3, (2, 4), None),        # 3 groups: no layer owned
])
def test_moment_bytes_equal_the_dry_runs(arch, layers, shape, rules):
    cfg = dataclasses.replace(configs.get_smoke(arch), n_layers=layers)
    opt = dryrun.specs.default_opt(cfg)
    mh = mesh(shape)
    sm = spmd.shard_model(init(cfg_of(cfg, "float32")), mh, rules)
    with sh.axis_rules(mh, rules):
        st = T.init_sharded_opt_state(opt, sm)
        ms = T.moment_specs(opt, sm)
    want = dryrun.mesh_bytes(cfg, SHAPES["train_4k"], mh.shape, sm.rules)
    for i in range(mh.size):
        assert _moment_bytes(st, i) == want["opt"], (i, want)
    owned = O.layer_stacks(sm, ms)
    n_data = mh.shape["data"]
    assert bool(owned) == (cfg.n_groups % n_data == 0)
    for entry, names in owned:
        assert len(names) == cfg.n_groups
        for g, name in enumerate(names):
            held = [t is not None for t in st["m"][name].shards]
            for c, h in zip(mh.coords(), held):
                per = cfg.n_groups // n_data
                assert h == (c["data"] == g // per), (name, c)


def test_int8_moments_are_not_owned():
    cfg = dataclasses.replace(configs.get_smoke("granite-34b"), n_layers=4)
    opt = O.AdamWConfig(quantize=True)
    mh = mesh((2, 4))
    sm = spmd.shard_model(init(cfg), mh)
    with sh.axis_rules(mh):
        ms = T.moment_specs(opt, sm)
        st = T.init_sharded_opt_state(opt, sm)
    assert O.layer_stacks(sm, ms) == []
    assert all(t is not None for x in st["m"].values() for t in
               x["q"].shards)


def _steps(cfg, owned, n=3):
    mh = mesh((2, 4))
    sm = spmd.shard_model(init(cfg), mh)
    losses, reds = [], []
    with sh.axis_rules(mh):
        ms = T.moment_specs(OPT, sm)
        if not owned:
            ms = T.per_layer(ms)
        st = O.sharded_adamw_init(OPT, sm, ms)
        for i in range(n):
            loss, parts = T.sharded_loss_and_grads(sm, batch(cfg, 8, 32))
            red = T.reduce_grads(sm, parts, ms)
            O.sharded_adamw_update(OPT, red, st, sm, ms)
            losses.append(float(loss))
            reds.append({k: O.moment_sharded(sm, k, ms[k], v).full()
                         for k, v in red.items()})
            if i == 0:
                first = {k: p.full() for k, p in sm.params.items()}
    return losses, reds, first, {k: p.full() for k, p in sm.params.items()}, \
        sm, st, ms


def test_three_steps_against_every_layer_on_every_coordinate():
    cfg = cfg_of(dataclasses.replace(configs.get_smoke("granite-34b"),
                                     n_layers=4), "float32")
    l1, r1, f1, p1, sm, st, ms = _steps(cfg, owned=True)
    l2, r2, f2, p2, _, _, _ = _steps(cfg, owned=False)
    assert l1[0] == l2[0]
    data_only = [k for k, p in sm.params.items()
                 if "model" in {a for e in p.spec for a in sh.axes_of(e)}]
    assert data_only
    for k in data_only:                 # one sum over "data": bitwise
        assert torch.equal(r1[0][k], r2[0][k]), k
        assert torch.equal(f1[k], f2[k]), k
    for k in p1:
        scale = float(p2[k].abs().max())
        assert float((p1[k] - p2[k]).abs().max()) <= 1e-5 * scale, k
    for a, b in zip(l1, l2):
        assert abs(a / b - 1) < 1e-6
    # the owners alone hold a layer's moments and its reduced gradient
    for entry, names in O.layer_stacks(sm, ms):
        for g, name in enumerate(names):
            owners = O.moment_layout(sm, name, ms[name])[1]
            assert owners == [c["data"] == g // 2 for c in sm.mesh.coords()]
            assert [t is not None for t in st["v"][name].shards] == owners
