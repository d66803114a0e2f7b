"""The collectives across processes on the card: two gloo ranks on
``cuda:0`` (a mesh of one card named twice, bound to the process group;
CUDA tensors staged through host memory), each collective and its
backward bit for bit the one-process mesh's on the card (groups of 2),
the counts equal, ``Sharded.full`` an all-gather or a gather to rank 0.
Runs where a card is visible (``-m gpu``, ``--noconftest``: no JAX
here).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import _dist_workers as W

from repro_torch.launch import ranks

pytestmark = pytest.mark.gpu
SHAPE = (2,)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.fixture(scope="module")
def runs(card, tmp_path_factory):
    got = ranks.spawn(W.collectives_rank, 2, backend="gloo",
                      workdir=str(tmp_path_factory.mktemp("pg")),
                      args=(card, SHAPE), timeout=300)
    mesh = W.one_process_mesh(card, SHAPE)
    one = {name: W.run_case(mesh, name, [0, 1], card)
           for name in W.cases_of(SHAPE)}
    return got, one


def test_ranks_stage_cuda_tensors_through_the_host(runs):
    got, _ = runs
    assert [r["coords"] for r in got] == [[0], [1]]
    assert all(r["stage_on_host"] for r in got)


@pytest.mark.parametrize("name", W.cases_of(SHAPE))
def test_collective_on_the_card_matches_one_process(runs, name):
    got, one = runs
    ys, gs, counts = one[name]
    for r, out in enumerate(got):
        y, g, c = out["cases"][name]
        np.testing.assert_array_equal(y[0], ys[r], err_msg=f"{name} {r}")
        if gs is not None:
            np.testing.assert_array_equal(g[0], gs[r],
                                          err_msg=f"{name} backward {r}")
        assert c == counts


def test_full_and_refusals_on_the_card(runs):
    got, _ = runs
    for r in got:
        assert r["full_equal"] and r["full_partial_equal"]
        assert r["full_root_ok"]
        assert "names a card twice" in r["refusals"]["nccl_shared_card"]
