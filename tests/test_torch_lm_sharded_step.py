"""The sharded train step against the JAX package's one-device step on the
CPU, and the two planted faults it must catch.

JAX's own case (``tests/test_distributed.py``'s sharded step): ``ModelConfig
("t", 2, 64, 4, 2, 128, 256, dtype="float32")``, ``SyntheticTokens(256, 8,
32, seed=1)``, ``AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)``.
JAX's weights go to the port by ``convert.model_from_jax`` and onto a
(data 2, model 4) mesh of the CPU by ``spmd.shard_model``; the port's step
is ``trainer.build_train_step`` inside ``sharding.axis_rules`` (ZeRO-1 on,
as JAX's default). Two steps (the first has lr 0 under the warmup), JAX's
bounds: the loss rtol 1e-5, the parameters rtol 2e-4 and atol 2e-5.

Planted faults, each put in by ``monkeypatch`` for one test: the ``wo``
all-reduce dropped in one layer (the loss and the gradients leave their
bounds), and each replica's gradient counted in the clipping norm with
clipping on (the norm and the first moments leave theirs).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401

from repro.data.pipeline import SyntheticTokens
from repro.models.config import ModelConfig as JConfig
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import sharding as tsh
from repro_torch.models import spmd
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer

ARGS = ("t", 2, 64, 4, 2, 128, 256)
GRAD_TOL = 1e-6


def _mesh(shape=(2, 4)):
    return Mesh(np.full(shape, "cpu", dtype=object), ("data", "model"))


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def _port_params(cfg, params):
    """{port name: array} of a JAX params tree."""
    out = {"embed": params["embed"], "unembed": params["unembed"],
           "norm_final": params["norm_final"]}
    for bname, blk in params["groups"].items():
        i = int(bname[len("block"):].split("_")[0])
        flat = {}
        for k, v in blk.items():
            if isinstance(v, dict):
                flat.update({f"{k}.{s}": a for s, a in v.items()})
            else:
                flat[k] = v
        for name, leaf in flat.items():
            for g in range(cfg.n_groups):
                out[f"blocks.{g * len(cfg.block_pattern) + i}.{name}"] = \
                    np.asarray(leaf[g])
    return out


@pytest.fixture(scope="module")
def jax_run():
    cfg = JConfig(*ARGS, dtype="float32")
    opt = jopt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params, state, axes = jtrainer.init_train_state(cfg, opt,
                                                    jax.random.PRNGKey(0))
    data = SyntheticTokens(256, 8, 32, seed=1)
    batches = [data.batch_at(i) for i in range(2)]
    step = jtrainer.build_train_step(cfg, opt, axes, donate=False)
    p, o, losses = params, state, []
    for b in batches:
        p, o, m = step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return {"cfg": cfg, "params0": _np(params), "batches": batches,
            "losses": losses, "params": _port_params(cfg, _np(p))}


def _sharded(jax_run, mesh, **over):
    tcfg = TConfig(*ARGS, dtype="float32")
    model = convert.model_from_jax(tcfg, jax_run["params0"], device="cpu")
    return tcfg, spmd.shard_model(model, mesh, over.get("rules"))


def test_sharded_step_matches_jax_one_device(jax_run):
    """Two steps on the (data 2, model 4) mesh, ZeRO-1 on: losses rtol
    1e-5 and the parameters rtol 2e-4 / atol 2e-5 of JAX's one-device
    steps; the moments of the embedding really split over "data"."""
    mesh = _mesh()
    tcfg, sm = _sharded(jax_run, mesh)
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    with tsh.axis_rules(mesh):
        step = ttrainer.build_train_step(tcfg, opt, tmodel.init_axes(tcfg))
        state = ttrainer.init_sharded_opt_state(opt, sm)
        losses = []
        for b in jax_run["batches"]:
            sm, state, m = step(sm, state, b)
            losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5)
    for name, want in jax_run["params"].items():
        np.testing.assert_allclose(sm.params[name].full().numpy(), want,
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    assert state["m"]["embed"].spec == ("model", "data")
    assert state["m"]["blocks.0.mixer.wq"].spec == (None, "model")
    assert int(state["count"]) == 2


def test_step_refuses_another_mesh(jax_run):
    tcfg, sm = _sharded(jax_run, _mesh())
    opt = topt.AdamWConfig()
    with tsh.axis_rules(_mesh()):
        step = ttrainer.build_train_step(tcfg, opt)
        with pytest.raises(ValueError, match="another config, mesh"):
            step(sm, ttrainer.init_sharded_opt_state(opt, sm),
                 jax_run["batches"][0])
    # outside axis_rules the step is the one-device step
    assert ttrainer.build_train_step(tcfg, opt).__qualname__.startswith(
        "make_step_fn")


def _one_device(jax_run, opt):
    tcfg = TConfig(*ARGS, dtype="float32")
    model = convert.model_from_jax(tcfg, jax_run["params0"], device="cpu")
    loss, grads = ttrainer.loss_and_grads(model, jax_run["batches"][0])
    state = topt.adamw_init(opt, dict(model.named_parameters()))
    _, state, metrics = topt.adamw_update(opt, grads, state,
                                          dict(model.named_parameters()))
    return float(loss), grads, state, float(metrics["grad_norm"])


def _sharded_errors(jax_run, opt, owned=True):
    """(loss error, worst gradient error / max|g|, worst first-moment
    error / max|m|, norm error) of one sharded step against the port's
    one-device step on JAX's weights; ``owned`` False keeps every layer's
    moments on every data coordinate (``trainer.per_layer``)."""
    loss1, g1, st1, n1 = _one_device(jax_run, opt)
    mesh = _mesh()
    _, sm = _sharded(jax_run, mesh)
    with tsh.axis_rules(mesh):
        ms = ttrainer.moment_specs(opt, sm)
        if not owned:
            ms = ttrainer.per_layer(ms)
        loss2, parts = ttrainer.sharded_loss_and_grads(
            sm, jax_run["batches"][0])
        red = ttrainer.reduce_grads(sm, parts, ms)
        st2 = topt.sharded_adamw_init(opt, sm, ms)
        _, st2, met = topt.sharded_adamw_update(opt, red, st2, sm, ms)
    gerr = max(float((topt.moment_sharded(sm, k, ms[k], red[k])
                      .full() - g).abs().max() / g.abs().max())
               for k, g in g1.items())
    merr = max(float((st2["m"][k].full() - m).abs().max() / m.abs().max())
               for k, m in st1["m"].items())
    return (abs(float(loss2) - loss1) / loss1, gerr, merr,
            abs(float(met["grad_norm"]) - n1) / n1)


def test_sharded_grads_and_moments_with_clipping(jax_run):
    """Clipping on (grad_clip 0.05, under the norm): the gradients within
    1e-6 of max|g| and the first moments within 1e-6 of max|m| of the
    port's one-device step, the norm rtol 1e-6."""
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=0, grad_clip=0.05)
    lerr, gerr, merr, nerr = _sharded_errors(jax_run, opt)
    assert lerr < 1e-6 and gerr < GRAD_TOL and merr < GRAD_TOL, \
        (lerr, gerr, merr)
    assert nerr < 1e-6


def test_planted_wo_all_reduce_dropped_fails(jax_run, monkeypatch):
    """Layer 0's ``wo`` all-reduce dropped: each model shard keeps its
    partial sum, and the gradients (and here the loss) leave their
    bounds."""
    real, calls = tlayers._row_reduce, []

    def drop_first_wo(outs, sm, axes, what):
        calls.append(what)
        if what == "wo" and calls.count("wo") == 1:
            return outs
        return real(outs, sm, axes, what)
    monkeypatch.setattr(tlayers, "_row_reduce", drop_first_wo)
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=0)
    lerr, gerr, _, _ = _sharded_errors(jax_run, opt)
    assert "wo" in calls
    assert lerr > 1e-5 and gerr > GRAD_TOL, (lerr, gerr)


def test_planted_norm_counts_replicas_fails(jax_run, monkeypatch):
    """Every coordinate's gradient counted in the clipping norm (replicas
    again): with clipping on, the norm and the first moments leave their
    bounds while the gradients stay in theirs. Where every data coordinate
    holds every layer (``owned`` False), each layer's data replicas count
    again; where layers are owned, only the replicas over "model" of the
    replicated leaves do, so the fault is smaller there, still far past
    the norm's bound of 1e-6."""
    monkeypatch.setattr(topt, "_counts_in_norm", lambda *a: True)
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=0, grad_clip=0.05)
    _, gerr, merr, nerr = _sharded_errors(jax_run, opt, owned=False)
    assert gerr < GRAD_TOL
    assert nerr > 1e-3 and merr > 1e-3, (nerr, merr)
    _, gerr, merr, nerr = _sharded_errors(jax_run, opt)
    assert gerr < GRAD_TOL
    assert nerr > 1e-4 and merr > 1e-4, (nerr, merr)
