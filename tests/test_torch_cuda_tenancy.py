"""Multi-tenant SpMM serving on the card: the pool's eviction freeing an
InCRS tenant's stripes, the engine's retire through pinned panels on its
copy stream against a plain synchronous copy of the same waves, a swap
after dispatch, and the cost model seeded from a bench record.

This file imports nothing of JAX, so it runs on a machine that has the card
and no JAX: ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_cuda_tenancy.py`` (the shared conftest imports JAX). On a
machine without CUDA every test skips.

Tolerance: served results against float64 ``1e-4 * max|C|`` (f32 sums);
the stream retire bitwise against the synchronous copy.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.incrs import InCRS                  # noqa: E402
from repro_torch.kernels import bsr_spmm as KB            # noqa: E402
from repro_torch.kernels import dense_mm as KD            # noqa: E402
from repro_torch.kernels import autotune                  # noqa: E402
from repro_torch.kernels import incrs_spmm as K           # noqa: E402
from repro_torch.kernels import ops                       # noqa: E402
from repro_torch.serve import TenantPool                  # noqa: E402
from repro_torch.serve import engine as E                 # noqa: E402
from repro_torch.serve.tenancy import operand_bytes       # noqa: E402
from repro_torch.sparse import api                        # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64_TOL = 1e-4
FORMAT_KERNEL = {"incrs": "incrs_spmm", "bsr": "bsr_spmm",
                 "dense": "dense_mm"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _counts():
    return {**K.LAUNCHES, **KB.LAUNCHES, **KD.LAUNCHES}


def _moved(before):
    return {k: v - before[k] for k, v in _counts().items() if v != before[k]}


def _sparse(m, k, density, seed):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((m, k)) < density,
                    rng.normal(size=(m, k)), 0.0).astype(np.float32)


def _close(got, want64):
    got = np.asarray(got, np.float64)
    scale = max(float(np.abs(want64).max()), 1e-30)
    err = float(np.abs(got - want64).max())
    assert err <= F64_TOL * scale, (err, scale)


ORDER_KERNEL = {"expand": "incrs_spmm", "reuse": "incrs_spmm_reuse",
                "pipelined": "incrs_spmm_pipelined"}


def _wave_kernels(fmt, eng, widths):
    """The launches of waves of these bucketed widths: the format's
    kernel, or for incrs the order ``auto`` picks at each width."""
    want = {}
    for w in widths:
        k = ORDER_KERNEL[ops.resolve_incrs(eng.prep, w)[0]] \
            if fmt == "incrs" else FORMAT_KERNEL[fmt]
        want[k] = want.get(k, 0) + 1
    return want


@pytest.fixture(autouse=True)
def _empty_tuning_cache(monkeypatch, tmp_path):
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "tune.json"))
    autotune.clear_memory_cache()


def _operand(fmt, d, device):
    if fmt == "incrs":
        return InCRS.from_dense(d)
    spec = api.SparseSpec(fmt, block=64 if fmt == "bsr" else None)
    return api.plan_for_operand(d, spec, device=device)


@pytest.mark.gpu
def test_evicting_an_incrs_tenant_frees_its_stripes(cuda):
    inc = InCRS.from_dense(_sparse(2048, 4096, 0.05, 1))
    pool = TenantPool(max_wave_cols=128)
    pool.add("keep", InCRS.from_dense(_sparse(256, 512, 0.1, 2)))
    nbytes = operand_bytes(pool.add("t", inc).prep)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    pool.evict("t")
    torch.cuda.synchronize()
    assert before - torch.cuda.memory_allocated(cuda) >= nbytes
    req = E.SpMMRequest(0, np.ones((4096, 8), np.float32))
    pool.submit("t", req)                      # revived, on the card again
    pool.run()
    assert pool.stats["revivals"] == 1
    _close(req.out, inc.crs.to_dense().astype(np.float64) @ req.b)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["incrs", "bsr", "dense"])
def test_stream_retire_matches_a_synchronous_copy(cuda, fmt, monkeypatch):
    """Each request is one full 128-column wave, so the same launch on
    the same B, copied back by ``.cpu()``, gives the same bits. Tensor
    requests keep their results after later waves reuse the panels, and
    the retire path never calls ``.cpu()``."""
    d = _sparse(512, 768, 0.1, 3)
    eng = E.SpMMEngine(_operand(fmt, d, cuda), max_wave_cols=128)
    gen = torch.Generator().manual_seed(4)
    panels = [torch.randn((768, 128), generator=gen) for _ in range(7)]
    reqs = [E.SpMMRequest(i, p if i % 2 else p.numpy())
            for i, p in enumerate(panels)]
    for r in reqs:
        eng.submit(r)

    def no_cpu(self, *a, **k):
        raise AssertionError("the retire path called .cpu()")

    before = _counts()
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "cpu", no_cpu)
        eng.run()
    assert eng.stats["waves"] == len(reqs)
    assert _moved(before) == _wave_kernels(fmt, eng, [128] * len(reqs))
    for r, p in zip(reqs, panels):
        b = p.to(cuda)
        want = (ops.spmm(eng.prep, b) if fmt == "incrs"
                else eng.prep(b)).cpu()
        got = r.out if isinstance(r.out, torch.Tensor) else \
            torch.from_numpy(r.out)
        assert torch.equal(got, want), r.rid
        _close(got, d.astype(np.float64) @ p.double().numpy())


@pytest.mark.gpu
def test_swap_after_dispatch_keeps_the_in_flight_wave(cuda):
    d1, d2 = _sparse(384, 640, 0.1, 5), _sparse(384, 640, 0.05, 6)
    eng = E.SpMMEngine(InCRS.from_dense(d1), max_wave_cols=256)
    rng = np.random.default_rng(7)
    r1 = E.SpMMRequest(0, rng.normal(size=(640, 200)).astype(np.float32))
    eng.submit(r1)
    eng.step(retire=False)
    assert eng._inflight is not None and not r1.done
    eng.swap_pattern(InCRS.from_dense(d2))
    r2 = E.SpMMRequest(1, rng.normal(size=(640, 200)).astype(np.float32))
    eng.submit(r2)
    eng.run()
    _close(r1.out, d1.astype(np.float64) @ r1.b)
    _close(r2.out, d2.astype(np.float64) @ r2.b)


@pytest.mark.gpu
def test_tenant_pool_on_the_card(cuda):
    """Three formats under a budget that holds one tenant: every request
    revives its tenant, is served within 1e-4 of float64, one launch a
    wave of the tenant's kernel."""
    d = _sparse(512, 768, 0.1, 8)
    pool = TenantPool(max_wave_cols=256, hbm_budget_bytes=1)
    for fmt in FORMAT_KERNEL:
        pool.add(fmt, _operand(fmt, d, cuda))
    rng = np.random.default_rng(9)
    for i in range(6):
        fmt = list(FORMAT_KERNEL)[i % 3]
        req = E.SpMMRequest(i, rng.normal(size=(768, 40 + 60 * i)).astype(
            np.float32))
        pool.submit(fmt, req)
        eng = pool.engine(fmt)
        before, waves = _counts(), eng.stats["waves"]
        pool.run()
        width = 40 + 60 * i                   # waves of at most 256
        parts = [256] * (width // 256) + [width % 256] * bool(width % 256)
        assert eng.stats["waves"] - waves == len(parts)
        assert _moved(before) == _wave_kernels(
            fmt, eng, [-(-w // 128) * 128 for w in parts])
        _close(req.out, d.astype(np.float64) @ req.b)
    stats = pool.summary()["stats"]
    assert stats["revivals"] >= 3 and stats["evictions"] >= 5


def _record(path, platform):
    path.write_text(json.dumps({"device": {"platform": platform}, "rows": [
        {"name": "incrs_spmm_expand", "us": 64.0, "derived": "cols=256"}]}))


@pytest.mark.gpu
def test_cuda_engine_seeds_from_a_gpu_record(cuda, tmp_path, monkeypatch):
    inc = InCRS.from_dense(_sparse(256, 512, 0.1, 10))
    monkeypatch.chdir(tmp_path)
    _record(tmp_path / E.DEFAULT_BENCH, "gpu")
    cost = E.SpMMEngine(inc).stats_summary()["cost_model"]
    assert cost["source"] == f"bench[{E.DEFAULT_BENCH}]"
    assert cost["us_per_col"] == pytest.approx(0.25)
    barrier = E.SpMMEngine(inc, continuous=False)
    assert barrier.stats_summary()["cost_model"]["source"] == "unseeded"
    _record(tmp_path / E.DEFAULT_BENCH, "cpu")
    assert E.SpMMEngine(inc).stats_summary()["cost_model"]["source"] == \
        "unseeded"
    monkeypatch.chdir(ROOT)                    # the committed record
    assert E.SpMMEngine(inc).stats_summary()["cost_model"]["source"] == \
        "bench[BENCH_torch_serve.json]"
