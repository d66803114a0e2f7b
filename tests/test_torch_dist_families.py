"""The MoE FFN, the SSD and RG-LRU mixers and sequence-parallel attention
across processes: the smoke configs of mixtral-8x7b, mamba2-370m and
recurrentgemma-2b (f32, JAX's weights through ``convert.model_from_jax``,
the recurrent mixers' leaves redrawn as ``tests/_sharded_jax.py`` draws
them) on a (data 2, model 2) mesh bound to a gloo process group of 4 CPU
processes (``_dist_workers.families_rank``), against the port's
one-process mesh of the same shape on the same weights and inputs.

Each family takes one AdamW step with FSDP and ZeRO-1 and serves a
prefill of 20 positions and 4 decode steps; recurrentgemma-2b serves
under JAX's overrides of its prefill cell (``attn_q_seq``: each
coordinate attends its span of the queries; ``cache_seq``) on the long
branch (``FLASH_THRESHOLD`` lowered to the prompt, flash chunks of 8).
Held: the loss and the clipping norm within ``ONE_PROCESS_TOL`` (relative),
every parameter and every call's logits within it of the tensor's max
(f32 sums over a group of 4 add in another order), the MoE routes of every
call (``ShardedModel.joined_routes``, all-gathered across the ranks)
equal, and every rank's collectives the one-process run's.
"""
from __future__ import annotations

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401
import _dist_workers as W
from _sharded_jax import _pair

from repro.data.pipeline import SyntheticTokens
from repro_torch.launch import ranks

ONE_PROCESS_TOL = 1e-6
SPAWN_TIMEOUT = 300
PAIRS = {"mixtral-8x7b": "mixtral", "mamba2-370m": "mamba2",
         "recurrentgemma-2b": "recurrentgemma_overrides"}
DECODES = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = {}
    for arch, case in PAIRS.items():
        jcfg, _, model = _pair(case)
        weights = {k: t.detach().numpy().copy() for k, t in
                   list(model.named_parameters()) +
                   list(model.named_buffers())}
        batch = SyntheticTokens(jcfg.vocab_size, 4, 24, seed=3).batch_at(0)
        rng = np.random.default_rng(4)
        toks = rng.integers(0, jcfg.vocab_size, (4, W.PROMPT)).astype(
            np.int32)
        feed = rng.integers(0, jcfg.vocab_size, (4, DECODES)).astype(
            np.int32)
        cases[arch] = (model.cfg, weights, batch, toks, feed)
    one = W.families_run(cases, W.one_process_mesh())
    got = ranks.spawn(W.families_rank, W.WORLD, backend="gloo",
                      workdir=str(tmp_path_factory.mktemp("pg_families")),
                      timeout=SPAWN_TIMEOUT, args=(cases,))
    return one, got


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ONE_PROCESS_TOL * scale, err_msg=what)


@pytest.mark.parametrize("arch", list(PAIRS))
def test_step_matches_the_one_process_mesh(runs, arch):
    one, got = runs
    want = one[arch]
    for r in got:
        mine = r["families"][arch]
        for a, b in zip(mine["steps"], want["steps"]):
            np.testing.assert_allclose(a["loss"], b["loss"],
                                       rtol=ONE_PROCESS_TOL)
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                       rtol=ONE_PROCESS_TOL)
            assert a["collectives"] == b["collectives"], r["rank"]
    params = got[0]["families"][arch]["params"]
    assert set(params) == set(want["params"])
    for k, w in want["params"].items():
        _close(params[k], w, f"{arch} {k}")


@pytest.mark.parametrize("arch", list(PAIRS))
def test_serve_matches_the_one_process_mesh(runs, arch):
    one, got = runs
    want = one[arch]["serve"]
    assert len(want["logits"]) == DECODES + 1
    for r in got:
        mine = r["families"][arch]["serve"]
        assert mine["collectives"] == want["collectives"], r["rank"]
        assert mine["cache_end"] == want["cache_end"] == W.PROMPT + DECODES
        assert mine["cache_spec"] == want["cache_spec"]
        for t, (a, b) in enumerate(zip(mine["logits"], want["logits"])):
            _close(a, b, f"{arch} rank {r['rank']} call {t}")
        assert len(mine["routes"]) == len(want["routes"])
        for a, b in zip(mine["routes"], want["routes"]):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_the_moe_routes_and_the_overrides_ran(runs):
    """mixtral's serve logged a route of the whole batch a layer a call;
    recurrentgemma's ran sequence-parallel attention (all-to-alls) and
    held its cache's slots over "model"."""
    one, got = runs
    for r in got:
        moe = r["families"]["mixtral-8x7b"]["serve"]["routes"]
        assert [len(x) for x in moe] == [2] * (DECODES + 1)
        assert moe[0][0].shape[:2] == (4, W.PROMPT)
        rg = r["families"]["recurrentgemma-2b"]["serve"]
        assert rg["collectives"]["all-to-all"]["count"] > 0
        assert rg["cache_spec"][1] == "model"
