"""The four collectives across processes: a (data 2, model 2) mesh bound
to a gloo process group of 4 CPU processes (``launch.ranks.spawn``, a
``file://`` rendezvous under ``tmp_path``, one process a coordinate),
each collective and its backward held against the one-process mesh's
``spmd._run`` on the same seeded inputs.

Bounds: a group of 2 agrees bit for bit (a + b commutes), and so does
every gather and all-to-all, which only move values; a sum over a group
of 4 (all-reduce, reduce-scatter, and the backward of an all-gather)
agrees within ``SUM4_TOL`` of the output's max, f32 rounding of four
terms added in another order. Every rank's counts equal the one-process
run's. ``Sharded.full`` is an all-gather (a coordinate that holds no
shard included), or a gather to one rank, and the mesh refuses a world of another size and, under
NCCL, two ranks on one card.
"""
from __future__ import annotations

import time

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401
import _dist_workers as W

from repro_torch.launch import ranks

SUM4_TOL = 1e-6          # of max|one-process output|: f32, 4 terms
NAMES = [c[0] for c in W.CASES]
GRAD_NAMES = [c[0] for c in W.CASES if c[1] != "all_reduce_max"]
SPAWN_TIMEOUT = 240


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    return ranks.spawn(W.collectives_rank, W.WORLD, backend="gloo",
                       workdir=str(tmp_path_factory.mktemp("pg")),
                       timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def one_process():
    mesh = W.one_process_mesh()
    return {name: W.run_case(mesh, name, list(range(W.WORLD)))
            for name in NAMES}


def _hold(got, want, exact, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=SUM4_TOL * scale, err_msg=what)


def test_each_rank_runs_its_own_coordinate(ranks_out):
    assert [r["rank"] for r in ranks_out] == list(range(W.WORLD))
    assert [r["coords"] for r in ranks_out] == [[r] for r in range(W.WORLD)]
    assert not any(r["stage_on_host"] for r in ranks_out)   # CPU tensors


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_one_process(ranks_out, one_process, name):
    want = one_process[name][0]
    for r, out in enumerate(ranks_out):
        _hold(out["cases"][name][0][0], want[r], W.exact(name, False),
              f"{name} rank {r}")


@pytest.mark.parametrize("name", GRAD_NAMES)
def test_backward_matches_one_process(ranks_out, one_process, name):
    want = one_process[name][1]
    for r, out in enumerate(ranks_out):
        _hold(out["cases"][name][1][0], want[r], W.exact(name, True),
              f"{name} backward rank {r}")


@pytest.mark.parametrize("name", NAMES)
def test_counts_equal_on_every_rank(ranks_out, one_process, name):
    want = one_process[name][2]
    assert sum(v["count"] for v in want.values()) > 0
    for r, out in enumerate(ranks_out):
        assert out["cases"][name][2] == want, f"{name} rank {r}"


def test_full_gathers_every_shard(ranks_out):
    assert all(r["full_equal"] for r in ranks_out)
    assert all(r["full_partial_equal"] for r in ranks_out)


def test_full_to_a_root_gathers_to_it_alone(ranks_out):
    """``full(root=0)``, as a checkpoint's save gathers: rank 0 gets the
    whole tensor (a coordinate that holds no shard included), the others
    None."""
    assert all(r["full_root_ok"] for r in ranks_out)


def test_the_mesh_refuses_a_wrong_world_and_a_shared_card_under_nccl(
        ranks_out):
    for r in ranks_out:
        assert "8 coordinates" in r["refusals"]["world"]
        assert "names a card twice" in r["refusals"]["nccl_shared_card"]


def test_a_process_mesh_needs_an_initialised_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        W.Mesh(np.full((2,), "cpu", dtype=object), ("data",),
               process_group=True)


def test_spawn_fails_when_a_rank_raises(tmp_path):
    with pytest.raises(Exception, match="rank [01] fails on purpose"):
        ranks.spawn(W.raising_rank, 2, backend="gloo", workdir=str(tmp_path),
                    timeout=SPAWN_TIMEOUT)


def test_spawn_fails_when_a_rank_outlives_its_deadline(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="ran past"):
        ranks.spawn(W.sleeping_rank, 2, backend="gloo",
                    workdir=str(tmp_path), args=(120.0,), timeout=6)
    assert time.monotonic() - t0 < 60       # killed, not waited for


def test_spawn_refuses_a_used_workdir(tmp_path):
    (tmp_path / "rank0.pt").write_bytes(b"")
    with pytest.raises(ValueError, match="already holds"):
        ranks.spawn(W.raising_rank, 2, backend="gloo", workdir=str(tmp_path))
