"""The port's multi-tenant SpMM serving (``TenantPool``), the seeding of the
wave cost model, the engine's host-panel ring, and the port's serve bench
and spmm_serve example, on the CPU.

The pool is held against the JAX pool on one scripted sequence: equal
stats, residency after every step, device bytes of every InCRS tenant, and
outputs within rtol = atol = 1e-4 (another f32 summation order). Both run
``variant="expand"``: JAX's "auto" may pick the pipelined kernel, which
does not trace on the installed jax (ROADMAP fault C1).
"""
import json

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401

torch = pytest.importorskip("torch")

from repro.core.incrs import InCRS as JInCRS              # noqa: E402
from repro.serve import engine as jeng                    # noqa: E402
from repro.serve import scheduler as jsched               # noqa: E402
from repro.serve import tenancy as jten                   # noqa: E402
from repro_torch import convert                           # noqa: E402
from repro_torch.benchmarks import serve_bench            # noqa: E402
from repro_torch.core.incrs import InCRS                  # noqa: E402
from repro_torch.examples import spmm_serve               # noqa: E402
from repro_torch.kernels import _gemm                     # noqa: E402
from repro_torch.kernels import incrs_spmm as K           # noqa: E402
from repro_torch.kernels import ops                       # noqa: E402
from repro_torch.serve import TenantPool                  # noqa: E402
from repro_torch.serve import engine as teng              # noqa: E402
from repro_torch.serve import scheduler as tsched         # noqa: E402
from repro_torch.serve.engine import SpMMRequest          # noqa: E402
from repro_torch.serve.tenancy import operand_bytes       # noqa: E402
from repro_torch.sparse import api                        # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _random_sparse(rng, m, k, density):
    d = rng.normal(size=(m, k)).astype(np.float32)
    d[rng.random(size=(m, k)) >= density] = 0.0
    return d


def _make_inc(rng, m, k, density=0.1):
    d = _random_sparse(rng, m, k, density)
    return d, InCRS.from_dense(d)


def _cpu_pool(**kw):
    return TenantPool(device="cpu", **kw)


# ----------------------------------------------------------------------
# JAX tests/test_serve_continuous.py's pool cases, on the port.
def test_tenant_pool_serves_many_operands(rng):
    d1, inc1 = _make_inc(rng, 16, 200)
    d2, inc2 = _make_inc(rng, 32, 100)
    pool = _cpu_pool()
    pool.add("alpha", inc1, max_wave_cols=64)
    pool.add("beta", inc2, max_wave_cols=64)
    r1 = SpMMRequest(0, rng.normal(size=(200, 8)).astype(np.float32))
    r2 = SpMMRequest(1, rng.normal(size=(100, 8)).astype(np.float32))
    pool.submit("alpha", r1)
    pool.submit("beta", r2)
    served = pool.run()
    assert len(served) == 2 and r1.done and r2.done
    np.testing.assert_allclose(r1.out, d1 @ r1.b, **TOL)
    np.testing.assert_allclose(r2.out, d2 @ r2.b, **TOL)
    s = pool.summary()
    assert s["n_resident"] == 2 and s["resident_bytes"] > 0


def test_tenant_pool_lru_eviction_and_revival(rng):
    d1, inc1 = _make_inc(rng, 64, 400)
    d2, inc2 = _make_inc(rng, 64, 400)
    pool = _cpu_pool(max_wave_cols=64)
    one = operand_bytes(pool.add("one", inc1).prep)
    pool.hbm_budget_bytes = int(one * 1.5)     # room for exactly one
    pool.add("two", inc2)
    assert not pool._tenants["one"].resident   # LRU evicted
    assert pool._tenants["two"].resident
    assert pool.stats["evictions"] == 1
    req = SpMMRequest(0, rng.normal(size=(400, 8)).astype(np.float32))
    pool.submit("one", req)                    # transparently revived
    pool.run("one")
    np.testing.assert_allclose(req.out, d1 @ req.b, **TOL)
    assert pool.stats["revivals"] == 1
    assert not pool._tenants["two"].resident   # budget held: two evicted
    assert len(pool.results("one")) == 1


def test_tenant_pool_never_evicts_busy_tenant(rng):
    _, inc1 = _make_inc(rng, 64, 400)
    _, inc2 = _make_inc(rng, 64, 400)
    pool = _cpu_pool(max_wave_cols=64)
    pool.add("one", inc1)
    pool.submit("one", SpMMRequest(
        0, rng.normal(size=(400, 8)).astype(np.float32)))
    pool.hbm_budget_bytes = 1                  # nothing fits
    pool.add("two", inc2)                      # "one" is busy: overcommit
    assert pool._tenants["one"].resident
    assert pool.stats["budget_overcommit"] >= 1
    with pytest.raises(ValueError, match="in-flight|queued"):
        pool.evict("one")
    pool.run("one")
    pool.evict("one")                          # drained: now evictable
    assert not pool._tenants["one"].resident


def test_tenant_pool_swap_survives_eviction(rng):
    """After a swap, an evict/revive cycle rebuilds the NEW operand, not
    the one the tenant was added with."""
    d1, inc1 = _make_inc(rng, 16, 200)
    d2, inc2 = _make_inc(np.random.default_rng(3), 16, 200)
    pool = _cpu_pool(max_wave_cols=64)
    pool.add("t", inc1)
    pool.swap_pattern("t", inc2)
    pool.evict("t")
    req = SpMMRequest(0, rng.normal(size=(200, 8)).astype(np.float32))
    pool.submit("t", req)                      # revive from the kept a
    pool.run("t")
    np.testing.assert_allclose(req.out, d2 @ req.b, **TOL)


def test_tenant_pool_smem_report(rng):
    """The counterpart of JAX's vmem_report case: each resident tenant's
    shared memory for one launch at its wave cap, from the wrappers' own
    geometry functions, within the card's limit; unknown tenants raise."""
    d, inc = _make_inc(rng, 32, 200)
    pool = _cpu_pool(max_wave_cols=64)
    pool.add("t", inc)
    pool.add("bsr", api.plan_for_operand(d[:, :192], api.SparseSpec(
        "bsr", block=16), device="cpu"))
    pool.add("dense", api.plan_for_operand(d, api.SparseSpec("dense"),
                                           device="cpu"))
    pool.add("reuse", inc, variant="reuse")
    rep = pool.smem_report()
    assert rep["limit_bytes"] == _gemm.SMEM_LIMIT
    kernels = {n: r["kernel"] for n, r in rep["tenants"].items()}
    assert kernels == {"t": "incrs_spmm", "bsr": "bsr_spmm",
                       "dense": "dense_mm", "reuse": "incrs_spmm_reuse"}
    for name, row in rep["tenants"].items():
        assert 0 < row["smem_bytes"] <= rep["limit_bytes"], name
        assert row["device_bytes"] == pool._tenants[name].resident_bytes > 0
        assert row["max_wave_cols"] == 64
    idx = pool.engine("t").prep.idx
    assert rep["tenants"]["t"]["smem_bytes"] == \
        K.launch_geometry("incrs_spmm", 128, idx.shape[2], 256)[1]
    pool.evict("t")
    assert "t" not in pool.smem_report()["tenants"]
    with pytest.raises(KeyError):
        pool.submit("ghost", SpMMRequest(
            0, rng.normal(size=(200, 4)).astype(np.float32)))


def _storage_bytes(tensors):
    seen = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in tensors}
    return sum(seen.values())


def test_operand_bytes_counts_every_tensor_a_bind_keeps(rng):
    d = _random_sparse(rng, 64, 128, 0.2)
    d[:16] = 0.0                                  # an empty block-row
    bsr = api.plan_for_operand(d, api.SparseSpec("bsr", block=16),
                               device="cpu")
    lists = bsr.plan.meta.kernel_index(bsr.device)
    assert bsr._ready.shape[0] > bsr.values.shape[0]   # padded slots
    assert operand_bytes(bsr) == _storage_bytes(
        [bsr.values, bsr._ready, *lists])
    inc = api.plan_for_operand(d, api.SparseSpec("incrs", section=64),
                               device="cpu")
    assert operand_bytes(inc) == inc.values.nbytes + inc._ready.idx.nbytes
    dense = api.plan_for_operand(d, api.SparseSpec("dense"), device="cpu")
    assert operand_bytes(dense) == _storage_bytes([dense.values,
                                                   dense._ready])
    prep = ops.prepare_incrs(InCRS.from_dense(d), device="cpu")
    assert operand_bytes(prep) == prep.idx.nbytes + prep.val.nbytes


def test_evicting_a_raw_incrs_tenant_drops_its_memo_entry(rng):
    _, inc = _make_inc(rng, 32, 200)
    pool = _cpu_pool(max_wave_cols=64)
    prep = pool.add("t", inc).prep
    assert ops.prepare_incrs(inc, device="cpu") is prep     # memo hit
    pool.evict("t")
    assert ops.prepare_incrs(inc, device="cpu") is not prep


# ----------------------------------------------------------------------
# One scripted sequence through the JAX pool and the port's.
def _pair(rng, m, k, density):
    j = JInCRS.from_dense(_random_sparse(rng, m, k, density))
    t = convert.incrs_from_arrays(j.crs.values, j.crs.col_idx, j.crs.row_ptr,
                                  j.shape, j.counters, j.section, j.block)
    return j, t


def test_tenant_pool_matches_jax_pool():
    rng = np.random.default_rng(7)
    shapes = {"small": (16, 300, 0.1), "mid": (64, 600, 0.1),
              "big": (96, 900, 0.15)}
    pairs = {n: _pair(rng, *s) for n, s in shapes.items()}
    swap = _pair(rng, 64, 600, 0.05)
    jpool = jten.TenantPool(max_wave_cols=128, variant="expand")
    tpool = TenantPool(max_wave_cols=128, variant="expand", device="cpu")
    pools = ((jpool, jeng.SpMMRequest), (tpool, SpMMRequest))
    for name, (j, t) in pairs.items():
        jpool.add(name, j)
        tpool.add(name, t)
        assert jpool._tenants[name].resident_bytes == \
            tpool._tenants[name].resident_bytes, name
    # room for "big" and one more, never for all three
    budget = jpool._tenants["big"].resident_bytes + \
        jpool._tenants["mid"].resident_bytes
    for pool, _ in pools:
        pool.hbm_budget_bytes = budget
    script = [("submit", "small", 40), ("run", None), ("submit", "mid", 200),
              ("submit", "small", 24), ("run", None), ("submit", "big", 96),
              ("run", "big"), ("submit", "small", 8), ("submit", "mid", 130),
              ("run", None), ("evict", "big"), ("swap", "mid"),
              ("submit", "mid", 64), ("submit", "big", 300), ("run", None),
              ("submit", "small", 16), ("run", "small")]
    outs = {id(p): [] for p, _ in pools}
    for step in script:
        for pool, req_cls in pools:
            jax_side = pool is jpool
            if step[0] == "submit":
                _, name, cols = step
                b = np.random.default_rng(cols).normal(
                    size=(shapes[name][1], cols)).astype(np.float32)
                req = req_cls(len(outs[id(pool)]), b)
                outs[id(pool)].append(req)
                pool.submit(name, req)
            elif step[0] == "run":
                pool.run(step[1])
            elif step[0] == "evict":
                pool.evict(step[1])
            else:
                pool.swap_pattern(step[1], swap[0] if jax_side else swap[1])
        assert {n: t.resident for n, t in jpool._tenants.items()} == \
            {n: t.resident for n, t in tpool._tenants.items()}, step
        for name in shapes:
            jt, tt = jpool._tenants[name], tpool._tenants[name]
            assert jt.resident_bytes == tt.resident_bytes, (step, name)
            if tt.resident:
                assert tpool.engine(name)._operand_geometry() == \
                    jpool.engine(name)._operand_geometry()
    js, ts = jpool.summary(), tpool.summary()
    assert js["stats"] == ts["stats"]
    assert ts["stats"]["evictions"] >= 2 and ts["stats"]["revivals"] >= 2
    assert js["resident_bytes"] == ts["resident_bytes"]
    for name in shapes:
        assert js["tenants"][name]["evictions"] == \
            ts["tenants"][name]["evictions"]
    jouts, touts = outs[id(jpool)], outs[id(tpool)]
    assert all(r.done for r in jouts + touts)
    for jr, tr in zip(jouts, touts):
        np.testing.assert_allclose(tr.out, jr.out, **TOL)


# ----------------------------------------------------------------------
# Seeding the wave cost model.
def _gpu_record(tmp_path, platform="gpu"):
    path = tmp_path / "BENCH_torch_serve.json"
    path.write_text(json.dumps({
        "schema": "bench_serve/v1", "device": {"platform": platform},
        "rows": [{"name": "dense_mm_256", "us": 9.0},
                 {"name": "incrs_spmm_expand", "us": 40.0,
                  "derived": "cols=128;docword"},
                 {"name": "incrs_spmm_pipelined", "us": 90.0,
                  "derived": "cols=512;docword"},
                 {"name": "serve_continuous", "rps": 5.0}]}))
    return path


def _model(m):
    return (m.us_per_col, m.launch_overhead_us, m.source, m.n_observed)


@pytest.mark.parametrize("record", ["BENCH_kernels.json", "gpu", "cpu",
                                    "missing"])
def test_seed_from_bench_matches_jax(record, tmp_path):
    if record in ("gpu", "cpu"):
        path = str(_gpu_record(tmp_path, record))
    elif record == "missing":
        path = str(tmp_path / "none.json")
    else:
        path = record
    port = tsched.seed_from_bench(path)
    assert _model(port) == _model(jsched.seed_from_bench(path))
    assert _model(tsched.seed_cost_model(bench_path=path)) == _model(port)
    on_gpu = tsched.seed_from_bench(path, platform="gpu")
    if record == "gpu":
        assert _model(on_gpu) == _model(port)
        assert on_gpu.us_per_col == pytest.approx(90.0 / 512)
        assert on_gpu.source == f"bench[{path}]"
    else:
        assert on_gpu.us_per_col is None and on_gpu.source == "unseeded"
    assert tsched.seed_cost_model().source == "unseeded"


def test_cpu_engine_stays_unseeded(rng, tmp_path, monkeypatch):
    _gpu_record(tmp_path)
    monkeypatch.chdir(tmp_path)
    _, inc = _make_inc(rng, 16, 200)
    eng = teng.SpMMEngine(inc, device="cpu")
    cost = eng.stats_summary()["cost_model"]
    assert cost["source"] == "unseeded" and cost["us_per_col"] is None


# ----------------------------------------------------------------------
# The engine's host-panel ring.
def _ring_trace(k, dtype=torch.float32):
    gen = torch.Generator().manual_seed(5)
    widths = [128, 40, 88, 128, 300, 16, 128, 64, 200, 520]
    return [torch.randn((k, w), generator=gen).to(dtype) for w in widths]


@pytest.mark.filterwarnings("ignore:SpMMEngine. wave dtype")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tensor_results_own_their_memory(rng, dtype):
    """A tensor request's ``out`` is not a view of a host panel: later
    waves reuse the panels, and every result still equals its product."""
    d, inc = _make_inc(rng, 48, 256)
    eng = teng.SpMMEngine(inc, max_wave_cols=128, device="cpu",
                          variant="expand")
    panels = _ring_trace(256, dtype)
    reqs = [SpMMRequest(i, p) for i, p in enumerate(panels)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert eng.stats["waves"] > 2 * teng.PANEL_RING
    ring = eng._panels._bufs[torch.float32]
    assert len(ring) == teng.PANEL_RING
    dense = torch.from_numpy(d).double()
    for r in reqs:
        assert r.out.dtype == dtype and r.out.is_contiguous()
        assert all(r.out.untyped_storage().data_ptr() !=
                   b.untyped_storage().data_ptr() for b in ring)
        np.testing.assert_allclose(r.out.double().numpy(),
                                   (dense @ r.b.double()).numpy(), **TOL)


def test_continuous_and_wave_barrier_results_bitwise_equal(rng):
    _, inc = _make_inc(rng, 48, 256)
    outs = []
    for continuous in (True, False):
        eng = teng.SpMMEngine(inc, max_wave_cols=256, device="cpu",
                              continuous=continuous, variant="expand")
        reqs = [SpMMRequest(i, p) for i, p in enumerate(_ring_trace(256))]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs.append([r.out for r in reqs])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_retire_false_keeps_the_wave_in_flight(rng):
    d, inc = _make_inc(rng, 32, 200)
    d2, inc2 = _make_inc(np.random.default_rng(9), 32, 200)
    eng = teng.SpMMEngine(inc, max_wave_cols=64, device="cpu")
    r1 = SpMMRequest(0, rng.normal(size=(200, 24)).astype(np.float32))
    eng.submit(r1)
    eng.step(retire=False)
    assert eng._inflight is not None and not r1.done
    eng.swap_pattern(inc2)                     # after dispatch
    r2 = SpMMRequest(1, rng.normal(size=(200, 24)).astype(np.float32))
    eng.submit(r2)
    eng.run()
    np.testing.assert_allclose(r1.out, d @ r1.b, **TOL)
    np.testing.assert_allclose(r2.out, d2 @ r2.b, **TOL)


# ----------------------------------------------------------------------
# The serve bench and the example, on the CPU at a small size.
def test_serve_bench_on_cpu(tmp_path, capsys):
    path = tmp_path / "bench.json"
    record = serve_bench.main(["--device", "cpu", "--smoke", "--json",
                               str(path)])
    assert json.loads(path.read_text()) == json.loads(json.dumps(record))
    assert record["schema"] == "bench_serve/v1"
    assert record["device"]["platform"] == "cpu"
    names = [r["name"] for r in record["rows"]]
    assert names[0] == "dense_mm_256"
    kernels = [r for r in record["rows"] if r["name"].startswith("incrs_")]
    assert sorted({(r["name"], r["derived"].split(";")[0])
                   for r in kernels}) == sorted(
        (f"incrs_spmm_{v}", f"cols={n}") for v in serve_bench.VARIANTS
        for n in (128, 256, 384, 512))
    assert "serve_wave_barrier" in names and "serve_continuous" in names
    cmp = record["comparisons"]["continuous_vs_wave_barrier"]
    assert cmp["barrier_waves"] >= cmp["continuous_waves"] > 0
    assert cmp["cost_model_source"] == "unseeded"
    assert "crosscheck,ok" in capsys.readouterr().out
    # a CPU record seeds nothing on a GPU engine, and JAX's contract holds
    assert tsched.seed_from_bench(str(path), platform="gpu").source == \
        "unseeded"
    assert _model(tsched.seed_from_bench(str(path))) == \
        _model(jsched.seed_from_bench(str(path)))
    assert serve_bench.check_regressions(record["rows"], str(path)) == []


def test_spmm_serve_example_on_cpu(capsys):
    out = spmm_serve.main(["--device", "cpu", "--scale", "0.06"])
    assert out["requests"] == 8 and out["max_rel_err"] <= spmm_serve.TOL
    assert out["continuous"]["requests"] == out["barrier"]["requests"] == 8
    assert out["device"]["platform"] == "cpu"
    assert "host clock, CPU" in capsys.readouterr().out
