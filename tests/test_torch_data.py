"""The port's token pipeline (``repro_torch.data.pipeline``) against the
JAX package's: every case of ``tests/test_data.py``'s pipeline part on
the port, and the batches bit for bit equal to JAX's for every (seed,
step, rank, world), prefix embeds included."""
import time

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe
from repro_torch.data.pipeline import Prefetcher, SyntheticTokens


def test_determinism_across_restarts():
    a = SyntheticTokens(100, 8, 16, seed=5).batch_at(3)
    b = SyntheticTokens(100, 8, 16, seed=5).batch_at(3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_rank_sharding_disjoint():
    r0 = SyntheticTokens(100, 8, 16, seed=5, rank=0, world=2).batch_at(0)
    r1 = SyntheticTokens(100, 8, 16, seed=5, rank=1, world=2).batch_at(0)
    assert r0["tokens"].shape == (4, 16)
    assert not np.array_equal(r0["tokens"], r1["tokens"])


def test_labels_are_shifted_tokens():
    b = SyntheticTokens(100, 2, 16, seed=1).batch_at(0)
    assert b["tokens"].shape == b["labels"].shape
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_prefetcher_basic():
    pf = Prefetcher(iter([{"x": i} for i in range(5)]), depth=2)
    got = [n["x"] for n in pf]
    assert got == list(range(5))


def test_prefetcher_straggler_fallback():
    def slow():
        yield {"x": 0}
        time.sleep(10)                 # straggling shard
        yield {"x": 1}
    pf = Prefetcher(slow(), depth=1, timeout_s=0.3,
                    fallback=lambda n: {"x": -n})
    assert next(pf)["x"] == 0
    assert next(pf)["x"] == -1         # deterministic filler, no stall
    assert pf.timeouts == 1
    pf.close()


def test_prefetcher_stall_without_fallback_raises():
    def stuck():
        time.sleep(10)
        yield {"x": 0}
    pf = Prefetcher(stuck(), depth=1, timeout_s=0.2)
    with pytest.raises(TimeoutError, match="stalled"):
        next(pf)
    pf.close()


def test_prefetcher_depth_bounds_the_queue():
    pf = Prefetcher(SyntheticTokens(50, 2, 4, seed=0), depth=2)
    time.sleep(0.3)
    assert pf._q.qsize() <= 2
    assert next(pf)["tokens"].shape == (2, 4)
    pf.close()


def test_indivisible_world_raises():
    for mod in (jpipe, tpipe):
        with pytest.raises(ValueError, match="not divisible by world 3"):
            mod.SyntheticTokens(100, 8, 16, world=3)


@pytest.mark.parametrize("seed,step,rank,world", [
    (0, 0, 0, 1), (5, 3, 0, 1), (5, 3, 1, 2), (7, 10**9 + 1, 3, 4),
    (123, 42, 2, 8)])
@pytest.mark.parametrize("n_prefix", [0, 3])
def test_batches_equal_jax_bit_for_bit(seed, step, rank, world, n_prefix):
    kw = dict(seed=seed, rank=rank, world=world, n_prefix=n_prefix,
              d_model=8)
    got = tpipe.SyntheticTokens(1000, 8, 16, **kw).batch_at(step)
    want = jpipe.SyntheticTokens(1000, 8, 16, **kw).batch_at(step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_iteration_follows_the_step():
    t = tpipe.SyntheticTokens(64, 2, 8, seed=2)
    j = jpipe.SyntheticTokens(64, 2, 8, seed=2)
    t.step = j.step = 5
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        if t.step >= 8:
            break
    assert t.step == 8
