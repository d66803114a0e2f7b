"""The sharded LM across processes: granite-34b's smoke config (f32) on a
(data 2, model 2) mesh bound to a gloo process group of 4 CPU processes,
one a coordinate (``launch.ranks.spawn``; the rank function is
``_dist_workers.lm_rank``), against JAX's one-device model and against the
port's one-process mesh of the same shape.

Held: three AdamW steps with FSDP and ZeRO-1 against JAX's jitted
``make_step_fn`` at ``tests/_sharded_jax.py``'s bounds (loss rtol 1e-5,
clipping norm rtol 1e-4, every parameter within 1e-4 of its max); a
prefill of 20 positions and 6 decode steps against JAX's ``prefill_step``
and ``decode_step`` (logits rtol = atol = 1e-4), under the default rules
and again under JAX's overrides of granite-34b's prefill cell (the
context-parallel cache, ``cache_seq``) on the long branch
(``FLASH_THRESHOLD`` lowered to the prompt, flash chunks of 8); the same
runs on the one-process mesh within ``ONE_PROCESS_TOL`` of each tensor's
max (f32 sums over a group of 4 add in another order), and every rank's
collectives equal to the one-process run's. A ZeRO-1 step (layer-owned
moments) saved from the process group is the file rank 0 gathered (the
other ranks keep no copy), the ranks restore their own shards bit for
bit, and onto one device the file restores equal to the one-process
run's checkpoint within ``ONE_PROCESS_TOL``.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401
import torch
import _dist_workers as W
from _sharded_jax import (LOGIT_TOL, STEP_TOL, _by_name, _pair, jnp, jopt,
                          jmodel, jtrainer, jax)

from repro.data.pipeline import SyntheticTokens
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import ranks
from repro_torch.models import model as M
from repro_torch.train import optimizer as O

ONE_PROCESS_TOL = 1e-6
SPAWN_TIMEOUT = 300


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's one-device run, the port's one-process run and the four
    ranks' runs of the same weights, batches and prompts."""
    jcfg, params, model = _pair("granite_zero1")
    cfg = model.cfg
    weights = {k: t.detach().numpy().copy() for k, t in
               list(model.named_parameters()) + list(model.named_buffers())}
    data = SyntheticTokens(jcfg.vocab_size, 4, 24, seed=3)
    batches = [data.batch_at(i) for i in range(3)]
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (4, W.PROMPT)).astype(np.int32)
    feed = rng.integers(0, jcfg.vocab_size, (4, W.DECODES)).astype(np.int32)
    jax_out = _jax_run(jcfg, params, batches, toks, feed)
    tmp = tmp_path_factory.mktemp("dist_lm")
    one = W.lm_run(cfg, weights, batches, toks, feed, W.one_process_mesh(),
                   str(tmp / "ckpt_one"))
    got = ranks.spawn(W.lm_rank, W.WORLD, backend="gloo",
                      workdir=str(tmp / "pg"), timeout=SPAWN_TIMEOUT,
                      args=(cfg, weights, batches, toks, feed,
                            str(tmp / "ckpt_pg")))
    return {"cfg": cfg, "jax": jax_out, "one": one, "ranks": got,
            "dirs": (str(tmp / "ckpt_pg"), str(tmp / "ckpt_one"))}


def _jax_run(jcfg, params, batches, toks, feed):
    opt = jopt.AdamWConfig(**W.OPT)
    step = jax.jit(jtrainer.make_step_fn(jcfg, opt))
    p, st, metrics = params, jopt.adamw_init(opt, params), []
    for b in batches:
        p, st, m = step(p, st, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    alloc = W.PROMPT + W.DECODES
    lg, cache = jmodel.prefill_step(jcfg, params, jnp.asarray(toks),
                                    alloc_seq=alloc,
                                    cache_dtype=jnp.float32)
    logits = [np.asarray(lg)]
    for t in range(W.DECODES):
        lg, cache = jmodel.decode_step(jcfg, params,
                                       jnp.asarray(feed[:, t:t + 1]), cache,
                                       pos=W.PROMPT + t)
        logits.append(np.asarray(lg))
    return {"steps": metrics, "params": _by_name(jcfg, p), "logits": logits}


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def test_steps_match_jax_one_device(runs):
    r0, ref = runs["ranks"][0], runs["jax"]
    for i, (got, want) in enumerate(zip(r0["steps"], ref["steps"])):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-4, err_msg=f"step {i}")
    assert set(r0["params"]) == set(ref["params"])
    for k, w in ref["params"].items():
        _close(r0["params"][k], w, STEP_TOL, k)


def test_steps_match_the_one_process_mesh(runs):
    one = runs["one"]
    for r in runs["ranks"]:
        for i, (got, want) in enumerate(zip(r["steps"], one["steps"])):
            np.testing.assert_allclose(got["loss"], want["loss"],
                                       rtol=ONE_PROCESS_TOL)
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                       rtol=ONE_PROCESS_TOL)
            assert got["collectives"] == want["collectives"], \
                f"rank {r['rank']} step {i}"
    for k, w in one["params"].items():
        _close(runs["ranks"][0]["params"][k], w, ONE_PROCESS_TOL, k)


SERVES = ("serve", "serve_overrides")


@pytest.mark.parametrize("serve", SERVES)
def test_prefill_and_decode_match_jax(runs, serve):
    ref = runs["jax"]["logits"]
    assert len(ref) == W.DECODES + 1
    for r in runs["ranks"]:
        assert r[serve]["cache_end"] == W.PROMPT + W.DECODES
        for t, (got, want) in enumerate(zip(r[serve]["logits"], ref)):
            np.testing.assert_allclose(got, want, rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL,
                                       err_msg=f"rank {r['rank']} call {t}")


@pytest.mark.parametrize("serve", SERVES)
def test_prefill_and_decode_match_the_one_process_mesh(runs, serve):
    one = runs["one"][serve]
    for r in runs["ranks"]:
        assert r[serve]["collectives"] == one["collectives"]
        assert r[serve]["cache_spec"] == one["cache_spec"]
        for t, (got, want) in enumerate(zip(r[serve]["logits"],
                                            one["logits"])):
            _close(got, want, ONE_PROCESS_TOL, f"rank {r['rank']} call {t}")


def test_the_overrides_serve_holds_its_cache_slots_over_model(runs):
    """``cache_seq``: the attention cache's slots split over "model" (the
    default rules split nothing there: one kv head)."""
    for r in runs["ranks"]:
        assert r["serve_overrides"]["cache_spec"][1] == "model"
        assert r["serve"]["cache_spec"][1] is None


def test_checkpoint_is_rank_zeros_gathered_state(runs):
    pg_dir, _ = runs["dirs"]
    saved = runs["ranks"][0]["checkpoint"]["saved"]
    for r in runs["ranks"][1:]:     # a gather to rank 0 leaves them none
        assert r["checkpoint"]["saved"] == {"params": None, "m": None}
    z = np.load(os.path.join(pg_dir, "step_00000001.npz"))
    for k, v in saved["params"].items():
        np.testing.assert_array_equal(z["params/" + k.replace(".", "/")], v)
    for k, v in saved["m"].items():
        np.testing.assert_array_equal(z[f"opt/m/{k}"], v)
    # layer-owned moments: a rank holds its coordinate's, as one process
    held_one = runs["one"]["checkpoint"]["held"]
    assert any(not all(h) for h in held_one.values())
    for r in runs["ranks"]:
        assert r["checkpoint"]["restored_equal"], r["rank"]
        assert {k: h[0] for k, h in r["checkpoint"]["held"].items()} == \
            {k: h[r["rank"]] for k, h in held_one.items()}


def test_checkpoint_restores_onto_one_device_as_the_one_process_one(runs):
    cfg = runs["cfg"]
    opt = O.AdamWConfig(**W.OPT)
    trees = []
    for d in runs["dirs"]:
        model = M.Model(cfg, device="cpu")
        st = O.adamw_init(opt, dict(model.named_parameters()))
        tree = CheckpointManager(d, async_write=False).restore(
            1, {"params": model, "opt": st})
        trees.append((model, tree["opt"]))
    (pg, pg_st), (one, one_st) = trees
    files = [np.load(os.path.join(d, "step_00000001.npz")).files
             for d in runs["dirs"]]
    assert files[0] == files[1]
    for (k, a), (_, b) in zip(pg.named_parameters(), one.named_parameters()):
        _close(a.detach().numpy(), b.detach().numpy(), ONE_PROCESS_TOL, k)
    for kind in ("m", "v"):
        for k, a in pg_st[kind].items():
            b = one_st[kind][k]
            assert a.dtype == b.dtype == torch.float32
            _close(a.numpy(), b.numpy(), ONE_PROCESS_TOL, f"{kind} {k}")
    assert int(pg_st["count"]) == int(one_st["count"]) == 1
