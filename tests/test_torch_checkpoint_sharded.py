"""Checkpoints of a sharded state: a ``ShardedModel`` and its sharded
AdamW state (ZeRO-1's layer-owned moments, int8 payloads and scales) saved
as whole arrays under the one-device keys, and restored onto a template
on any mesh and rule table, or onto one device (JAX's ``restore(step,
template, shardings)``).

Held here: a sharded save is the one-device save of ``gather_model`` (and
of the assembled moments), key for key and bit for bit; restores (2, 4) ->
(2, 4), (2, 4) -> (4, 2), (2, 4) -> one device and one device -> (2, 4),
with f32 and int8 moments, every array bit for bit and the next step's
loss bitwise on the same mesh, within 1e-5 elsewhere (f32 sums in another
order); a template of another architecture raises. mamba2-370m's smoke
config at 4 layers under ZeRO-1 without FSDP, so every block leaf's
moments are owned by layer.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401
import torch
from _sharded_lm import batch, cfg_of, init, mesh

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models import model as M
from repro_torch.models import sharding as sh
from repro_torch.models import spmd
from repro_torch.train import optimizer as O
from repro_torch.train import trainer as T

CFG = cfg_of(dataclasses.replace(configs.get_smoke("mamba2-370m"),
                                 n_layers=4), "float32")
OPTS = {"f32": O.AdamWConfig(lr=1e-3, warmup_steps=0),
        "int8": O.AdamWConfig(lr=1e-3, warmup_steps=0, quantize=True)}
LOSS_RTOL = 1e-5


def _batches():
    return [batch(CFG, 8, 16) for _ in range(2)]


def _sharded_run(tmp_path, opt):
    """A step on (data 2, model 4), a save, a second step: the manager,
    the uninterrupted second loss and the saved state's arrays."""
    mh = mesh((2, 4))
    sm = spmd.shard_model(init(CFG), mh)
    b = _batches()
    ck = CheckpointManager(str(tmp_path), async_write=False)
    with sh.axis_rules(mh):
        step = T.build_train_step(CFG, opt)
        st = T.init_sharded_opt_state(opt, sm)
        sm, st, _ = step(sm, st, b[0])
        ck.save(1, {"params": sm, "opt": st})
        saved = {"params": {k: p.full() for k, p in sm.params.items()},
                 "m": {k: _full(x) for k, x in st["m"].items()}}
        _, _, met = step(sm, st, b[1])
    return ck, float(met["loss"]), saved, b


def _full(x):
    return ({k: v.full() for k, v in x.items()} if isinstance(x, dict)
            else x.full())


def _same(a, b):
    if isinstance(a, dict):
        return all(_same(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("kind", OPTS)
def test_sharded_save_is_the_one_device_save(tmp_path, kind):
    opt = OPTS[kind]
    ck, _, saved, _ = _sharded_run(tmp_path / "sharded", opt)
    one = M.Model(CFG, device="cpu")
    with torch.no_grad():
        for k, p in one.named_parameters():
            p.copy_(saved["params"][k])
    st = O.adamw_init(opt, dict(one.named_parameters()))
    z = np.load(os.path.join(ck.dir, "step_00000001.npz"))
    st["m"] = saved["m"]
    st["v"] = {k: (dict(q=torch.from_numpy(z[f"opt/v/{k}/q"]),
                        s=torch.from_numpy(z[f"opt/v/{k}/s"]))
                   if opt.quantize else torch.from_numpy(z[f"opt/v/{k}"]))
               for k in st["v"]}
    st["count"] = torch.ones((), dtype=torch.int32)
    ck2 = CheckpointManager(str(tmp_path / "one"), async_write=False)
    ck2.save(1, {"params": one, "opt": st})
    z2 = np.load(os.path.join(ck2.dir, "step_00000001.npz"))
    assert z.files == z2.files
    for k in z.files:
        assert z[k].dtype == z2[k].dtype and np.array_equal(z[k], z2[k]), k
    # the one-device model's own keys, as the gathered model saves them
    ck3 = CheckpointManager(str(tmp_path / "gathered"), async_write=False)
    ck3.save(1, {"params": one})
    assert {k for k in z.files if k.startswith("params/")} == set(
        np.load(os.path.join(ck3.dir, "step_00000001.npz")).files)


@pytest.mark.parametrize("kind", OPTS)
@pytest.mark.parametrize("target", [(2, 4), (4, 2), None])
def test_restore_onto_a_mesh_or_one_device(tmp_path, kind, target):
    opt = OPTS[kind]
    ck, want, saved, b = _sharded_run(tmp_path, opt)
    if target is None:
        model = M.init(CFG, seed=3, device="cpu")
        st = O.adamw_init(opt, dict(model.named_parameters()))
        tree = ck.restore(1, {"params": model, "opt": st})
        for k, p in model.named_parameters():
            assert torch.equal(p, saved["params"][k]), k
        for k, m in tree["opt"]["m"].items():
            assert _same(m, saved["m"][k]), k
        _, _, met = T.make_step_fn(CFG, opt)(model, tree["opt"], b[1])
    else:
        mh = mesh(target)
        sm = spmd.shard_model(M.init(CFG, seed=3, device="cpu"), mh)
        with sh.axis_rules(mh):
            st = T.init_sharded_opt_state(opt, sm)
            tree = ck.restore(1, {"params": sm, "opt": st})
            assert tree["params"] is sm
            for k, p in sm.params.items():
                assert torch.equal(p.full(), saved["params"][k]), k
            for k, m in tree["opt"]["m"].items():
                assert _same(_full(m), saved["m"][k]), k
                held = [t is not None for t in
                        (m["q"] if isinstance(m, dict) else m).shards]
                assert held == [t is not None for t in
                                (st["m"][k]["q"] if isinstance(m, dict)
                                 else st["m"][k]).shards]
            _, _, met = T.build_train_step(CFG, opt)(sm, tree["opt"], b[1])
    if target == (2, 4):
        assert float(met["loss"]) == want
    else:
        assert abs(float(met["loss"]) / want - 1) < LOSS_RTOL


@pytest.mark.parametrize("kind", OPTS)
def test_one_device_checkpoint_onto_a_mesh(tmp_path, kind):
    opt = OPTS[kind]
    model = init(CFG)
    b = _batches()
    step = T.make_step_fn(CFG, opt)
    st = O.adamw_init(opt, dict(model.named_parameters()))
    model, st, _ = step(model, st, b[0])
    ck = CheckpointManager(str(tmp_path), async_write=False)
    ck.save(1, {"params": model, "opt": st})
    saved = {k: p.detach().clone() for k, p in model.named_parameters()}
    _, _, met = step(model, st, b[1])
    mh = mesh((2, 4))
    sm = spmd.shard_model(M.init(CFG, seed=3, device="cpu"), mh)
    with sh.axis_rules(mh):
        st2 = T.init_sharded_opt_state(opt, sm)
        tree = ck.restore(1, {"params": sm, "opt": st2})
        for k, p in sm.params.items():
            assert torch.equal(p.full(), saved[k]), k
        _, _, met2 = T.build_train_step(CFG, opt)(sm, tree["opt"], b[1])
    assert abs(float(met2["loss"]) / float(met["loss"]) - 1) < LOSS_RTOL


def test_a_template_of_another_architecture_raises(tmp_path):
    ck, _, _, _ = _sharded_run(tmp_path, OPTS["f32"])
    mh = mesh((2, 4))
    other = cfg_of(configs.get_smoke("granite-34b"), "float32")
    sm = spmd.shard_model(M.init(other, seed=0, device="cpu"), mh)
    with pytest.raises(ValueError, match="not the template's"):
        ck.restore(1, {"params": sm})
    deeper = dataclasses.replace(CFG, n_layers=6)
    sm = spmd.shard_model(M.init(deeper, seed=0, device="cpu"), mh)
    with pytest.raises(ValueError, match="not the template's"):
        ck.restore(1, {"params": sm})
    wider = dataclasses.replace(CFG, d_model=128)
    sm = spmd.shard_model(M.init(wider, seed=0, device="cpu"), mh)
    with pytest.raises(ValueError, match="shape"):
        ck.restore(1, {"params": sm})
