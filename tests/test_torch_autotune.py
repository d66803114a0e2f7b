"""The port's tuning layer on the CPU, held against the JAX package.

``kernels.autotune``'s keys, cache, sweep protocol and picks;
``core.mesh_sim``'s cost half; ``plan(tune=)``; the wave cost model's
autotune seed. Both packages' caches live under ``tmp_path`` (monkeypatched
environment), so no test reads or writes a user's cache. The JAX side runs
``variant="expand"`` or its cost model only: its ``auto`` may reach the
pipelined kernel, which does not trace on the installed jax (ROADMAP fault
C1). Numbers timed here are the CPU's plain versions, never the card's.
"""
import json
import logging

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                   # noqa: E402

from repro.core import mesh_sim as jmesh                  # noqa: E402
from repro.core.incrs import InCRS as JInCRS              # noqa: E402
from repro.kernels import autotune as jtune               # noqa: E402
from repro.kernels import ops as jops                     # noqa: E402
from repro.serve import scheduler as jsched               # noqa: E402
from repro_torch.analysis import launch_check as L        # noqa: E402
from repro_torch.core import mesh_sim as tmesh            # noqa: E402
from repro_torch.core.crs import CRS                      # noqa: E402
from repro_torch.core.incrs import InCRS                  # noqa: E402
from repro_torch.kernels import autotune as tune          # noqa: E402
from repro_torch.kernels import incrs_spmm as K           # noqa: E402
from repro_torch.kernels import ops                       # noqa: E402
from repro_torch.serve import scheduler as tsched         # noqa: E402
from repro_torch.sparse import SparseSpec                 # noqa: E402
from repro_torch.sparse.api import plan                   # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
PORT = {"expand": "incrs_spmm", "reuse": "incrs_spmm_reuse",
        "pipelined": "incrs_spmm_pipelined"}


@pytest.fixture
def caches(monkeypatch, tmp_path):
    """Both packages' tuning caches on files of this test alone."""
    port = tmp_path / "port.json"
    jax_path = tmp_path / "jax.json"
    monkeypatch.setenv(tune.CACHE_ENV, str(port))
    monkeypatch.setenv(jtune.CACHE_ENV, str(jax_path))
    tune.clear_memory_cache()
    jtune.clear_memory_cache()
    yield port, jax_path
    tune.clear_memory_cache()
    jtune.clear_memory_cache()


def _sparse(rng, m, k, density):
    a = rng.normal(size=(m, k)).astype(np.float32)
    return np.where(rng.random((m, k)) < density, a, 0.0).astype(np.float32)


def _cfg(us=100.0, **kw):
    base = dict(variant="reuse", bm=128, bn=128, measured_us=us,
                predicted_us=50.0, rounds=0, geometry=(128, 2400),
                n_cols=128)
    base.update(kw)
    return tune.TunedConfig(**base)


# ----------------------------------------------------------------------
# Keys.
@pytest.mark.parametrize("shape", [(768, 47, 33, 256, 512),
                                   (24576, 24, 51, 256, 512),
                                   (128, 1, 1, 32, 1), (6144, 96, 52, 64, 640)])
@pytest.mark.parametrize("backend", ["cuda-sm90", "cpu"])
def test_port_keys_parse_alike_in_both_packages(shape, backend):
    key = tune.cache_key(*shape, backend)
    assert key == jtune.cache_key(*shape, backend)
    assert tune.parse_cache_key(key) == jtune.parse_cache_key(key)
    parsed = tune.parse_cache_key(key)
    assert (parsed["padded_rows"], parsed["n_sections"], parsed["smax"],
            parsed["section"], parsed["n_cols"], parsed["backend"]) == \
        (*shape[:2], shape[2], shape[3], shape[4], backend)
    assert tune.matched_cache_key(1536, 1500, 12000, backend) == \
        jtune.matched_cache_key(1536, 1500, 12000, backend)
    for bad in ("im.m1.n2.k3.cpu", "m1.sec2.w3.n4.cpu", "x.y"):
        assert tune.parse_cache_key(bad) == jtune.parse_cache_key(bad)


def test_backend_names():
    assert tune.backend_name("cpu") == "cpu"
    assert tune.backend_name(torch.device("cpu")) == "cpu"


# ----------------------------------------------------------------------
# The disk cache.
def test_disk_round_trip_and_versioned_invalidation(caches):
    port, _ = caches
    key = tune.cache_key(768, 47, 33, 256, 512, "cpu")
    cfg = _cfg(geometry=(2, 24, 2, 3, 128, 1, 32, 4, 225584),
               variant="pipelined")
    tune._store_disk(key, cfg)
    tune.clear_memory_cache()
    got = tune.lookup(key)
    assert got == cfg
    assert got.launch_geometry == K.PipeGeometry(*cfg.geometry)
    assert tune.cached_configs() == {key: cfg}
    assert got.overhead_factor == pytest.approx(2.0)
    blob = json.loads(port.read_text())
    blob["version"] = tune.AUTOTUNE_VERSION + 1
    port.write_text(json.dumps(blob))
    tune.clear_memory_cache()
    assert tune.lookup(key) is None and tune.cached_configs() == {}
    port.write_text("{not json")
    assert tune.lookup(key) is None
    blob["version"] = tune.AUTOTUNE_VERSION
    blob["entries"][key] = {"variant": "expand"}        # a torn entry
    port.write_text(json.dumps(blob))
    assert tune.lookup(key) is None


def test_a_jax_cache_entry_is_never_read(caches, monkeypatch):
    """A JAX entry at the same shape and key, in the port's own file, is
    not picked up: the file is JAX's (no owner), so the port ignores it
    and ``auto`` takes the cost model's order."""
    port, _ = caches
    rng = np.random.default_rng(0)
    dense = _sparse(rng, 40, 300, 0.2)
    inc = InCRS.from_dense(dense, section=64)
    prep = ops.prepare_incrs(inc, device="cpu")
    key = tune.cache_key(*prep.idx.shape, prep.section, 48, "cpu")
    assert key == jtune.cache_key(*prep.idx.shape, prep.section, 48,
                                  jtune.backend_name(False))
    monkeypatch.setenv(jtune.CACHE_ENV, str(port))
    jtune._store_disk(key, jtune.TunedConfig("reuse", 128, 128, 1.0, 1.0))
    assert jtune.lookup(key) is not None
    assert tune.lookup(key) is None and tune.cached_configs() == {}
    want = tune.model_pick_variant(
        128, 128, n_sections=prep.n_sections, smax=prep.idx.shape[2],
        section=prep.section)
    assert ops.resolve_incrs(prep, 48)[0] == want


# ----------------------------------------------------------------------
# The cost model.
@pytest.mark.parametrize("variant", ["expand", "reuse", "pipelined"])
@pytest.mark.parametrize("shape", [(768, 512, 47, 33, 256),
                                   (128, 1024, 4, 32, 256),
                                   (24576, 512, 24, 51, 256),
                                   (6144, 640, 96, 52, 64)])
def test_fused_cost_flops_equal_jax(variant, shape):
    m, n, n_sections, smax, section = shape
    kw = dict(n_sections=n_sections, smax=smax, section=section, bm=128,
              bn=128)
    port = tmesh.fused_spmm_cost(variant, m, n, **kw)
    jax_cost = jmesh.fused_spmm_cost(variant, m, n, **kw)
    assert port.flops == jax_cost.flops
    assert port.fmas * 2 == port.flops
    nnz = m * n_sections * smax // 3
    assert tmesh.fused_spmm_cost(variant, m, n, nnz=nnz, **kw).flops == \
        jmesh.fused_spmm_cost(variant, m, n, nnz=nnz, **kw).flops
    assert port.predicted_us > 0 and port.waves >= 1
    assert port.hbm_bytes == port.stripe_bytes + port.b_bytes + port.c_bytes
    geo = K.launch_geometry(PORT[variant], n, smax, section,
                            m=-(-m // 128) * 128)
    assert port.geometry == tuple(geo)


def test_cost_follows_the_geometry():
    """One wave more costs a wave's time; the pipelined order reads B
    once per cluster of row tiles."""
    kw = dict(n_sections=47, smax=33, section=256)
    one = tmesh.fused_spmm_cost("expand", 768, 512,
                                geometry=K.expand_geometry(33, 8), **kw)
    tiny = tmesh.fused_spmm_cost("expand", 768, 512,
                                 geometry=K.expand_geometry(33, 1), **kw)
    assert tiny.ctas == 8 * one.ctas
    assert tiny.waves >= one.waves
    c1 = tmesh.fused_spmm_cost("pipelined", 768, 512, geometry=K.pipe_launch(
        768, 512, 33, 256, 2, 24, 1), **kw)
    c2 = tmesh.fused_spmm_cost("pipelined", 768, 512, geometry=K.pipe_launch(
        768, 512, 33, 256, 2, 24, 2), **kw)
    assert c1.b_bytes == 2 * c2.b_bytes


def test_spgemm_cost_prices_three_engines():
    rng = np.random.default_rng(2)
    a = CRS.from_dense(_sparse(rng, 200, 700, 0.05))
    cost = tmesh.spgemm_cost_for(a, a, rounds=64)
    us = cost.predicted_us()
    assert set(us) == {"reference", "condense_merge", "densify"}
    assert all(u > 0 for u in us.values())
    assert cost.pick == min(us, key=us.get)
    assert tune.pick_spgemm_engine(cost) == cost.pick
    assert cost.spgemm.launches == cost.densify.launches == 2


# ----------------------------------------------------------------------
# The sweep, its record and the picks.
def test_sweep_measures_checked_candidates_and_persists(caches):
    port, _ = caches
    rng = np.random.default_rng(1)
    dense = _sparse(rng, 60, 500, 0.15)
    prep = ops.prepare_incrs(InCRS.from_dense(dense, section=128),
                             device="cpu")
    b = torch.from_numpy(rng.normal(size=(500, 96)).astype(np.float32))
    seen = []

    def verify(variant, geo, out):
        seen.append((variant, tuple(geo)))
        np.testing.assert_allclose(out[:60, :96].numpy(),
                                   dense @ b.numpy(), **TOL)

    cfg = tune.tune(prep.idx, prep.val, b, section=128, reps=1, top_k=None,
                    verify=verify)
    rec = tune.LAST_SWEEP
    assert not rec.cache_hit and rec.winner == cfg
    assert len(rec.measured) == len(seen) == rec.n_candidates - \
        len(rec.skipped_infeasible)
    assert {m["variant"] for m in rec.measured} == set(PORT)
    assert cfg.measured_us == min(m["us"] for m in rec.measured)
    assert all(m["predicted_us"] > 0 for m in rec.measured)
    assert cfg.n_cols == 96 and cfg.bn == ops.default_bn(96)
    key = tune.cache_key(*prep.idx.shape, 128, 96, "cpu")
    assert key in json.loads(port.read_text())["entries"]
    assert tune.tune(prep.idx, prep.val, b, section=128) == cfg
    assert tune.LAST_SWEEP.cache_hit
    top = tune.tune(prep.idx, prep.val, b[:, :64], section=128, reps=1,
                    top_k=2)
    assert len(tune.LAST_SWEEP.measured) == 2 and top.n_cols == 64
    json.dumps(tune.LAST_SWEEP.to_json())


def test_sweep_without_a_feasible_candidate_raises(caches):
    """Stripes no order can stage (one row's slots over an SM's shared
    memory): the sweep raises naming the rules, as JAX's does."""
    idx = torch.full((8, 1, 16000), -1, dtype=torch.int32)
    idx[0, 0, :] = torch.arange(16000, dtype=torch.int32)
    val = torch.ones(idx.shape)
    b = torch.zeros((16000, 8))
    with pytest.raises(L.KernelConfigError, match="no candidate"):
        tune.tune(idx, val, b, section=16000)


def test_auto_rides_a_tuned_entry(caches):
    """ops.spmm(auto) with a cached entry launches its order and geometry:
    equal to JAX's expand within TOL and to the port's explicit order bit
    for bit."""
    rng = np.random.default_rng(5)
    dense = _sparse(rng, 70, 600, 0.1)
    b = rng.normal(size=(600, 100)).astype(np.float32)
    inc = InCRS.from_dense(dense, section=128)
    prep = ops.prepare_incrs(inc, device="cpu")
    cfg = tune.tune(prep.idx, prep.val, torch.from_numpy(b), section=128,
                    reps=1, top_k=None)
    assert ops.resolve_incrs(prep, 100) == (cfg.variant, cfg.bn,
                                            cfg.launch_geometry)
    got = ops.spmm(inc, b, device="cpu")
    jout = np.asarray(jops.spmm(JInCRS.from_dense(dense, section=128),
                                jnp.asarray(b), variant="expand"))
    np.testing.assert_allclose(got.numpy(), jout, **TOL)
    explicit = ops.spmm(inc, b, variant=cfg.variant, bn=cfg.bn,
                        device="cpu")
    assert torch.equal(got, explicit)


def test_a_stale_geometry_raises_and_never_falls_back(caches):
    """A cached launch that is not this shape's (another N's pipelined
    grid, an instance the source lacks) raises before any launch."""
    rng = np.random.default_rng(6)
    dense = _sparse(rng, 40, 300, 0.2)
    inc = InCRS.from_dense(dense, section=64)
    prep = ops.prepare_incrs(inc, device="cpu")
    key = tune.cache_key(*prep.idx.shape, 64, 48, "cpu")
    smax = prep.idx.shape[2]
    wrong_n = K.pipe_launch(128, 1024, smax, 64, 2, 8, 1)
    tune._MEM[key] = _cfg(variant="pipelined", geometry=tuple(wrong_n),
                          n_cols=48)
    with pytest.raises(L.KernelConfigError, match="geometry"):
        ops.spmm(inc, rng.normal(size=(300, 48)).astype(np.float32),
                 device="cpu")
    tune._MEM[key] = _cfg(variant="reuse", geometry=(96, 2400), n_cols=48)
    with pytest.raises(L.KernelConfigError, match="reuse_kernel<96>"):
        ops.spmm(inc, rng.normal(size=(300, 48)).astype(np.float32),
                 device="cpu")


def test_model_pick_logs_once_and_is_a_function_of_shapes(caches, caplog):
    kw = dict(n_sections=47, smax=33, section=256)
    with caplog.at_level(logging.INFO, logger=tune.__name__):
        first = tune.model_pick_variant(768, 512, **kw)
        again = tune.model_pick_variant(768, 512, **kw)
    lines = [r for r in caplog.records if "no tuned entry" in r.message]
    assert first == again and len(lines) == 1
    assert repr(first) in lines[0].message
    assert "expand=" in lines[0].message and "reuse=" in lines[0].message
    tune.clear_memory_cache()
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=tune.__name__):
        tune.model_pick_variant(768, 512, **kw)
    assert sum("no tuned entry" in r.message for r in caplog.records) == 1
    us = {v: tmesh.fused_spmm_cost(v, 768, 512, **kw).predicted_us
          for v in PORT}
    assert first == min(us, key=us.get)


def test_matched_sweep_and_spgemm_auto(caches):
    rng = np.random.default_rng(7)
    a = CRS.from_dense(_sparse(rng, 90, 400, 0.08))
    cfg = tune.tune_index_match(a, a, device="cpu", reps=1, top_k=None)
    assert cfg.variant == "index_match" and cfg.rounds in (32, 64, 128)
    assert {m["rounds"] for m in tune.LAST_SWEEP.measured} == {32, 64, 128}
    rounds, bm, bn, geo = ops._resolve_matched_tiles(90, 90, 400, None,
                                                     None, None, "cpu")
    assert (rounds, geo) == (cfg.rounds, cfg.launch_geometry)
    want = a.to_dense().astype(np.float64) @ a.to_dense().T
    for variant in ("auto", "reference"):
        out = ops.spmm(a, a, variant=variant, device="cpu")
        np.testing.assert_allclose(out.numpy(), want, **TOL)


# ----------------------------------------------------------------------
# plan(tune=): JAX tests/test_autotune.py's modes and errors.
def test_plan_tune_modes(caches):
    rng = np.random.default_rng(8)
    w = _sparse(rng, 64, 32, 0.3)                  # W (d_in, d_out)
    spec = SparseSpec("incrs", mask=w != 0, section=32, block=8)
    b = rng.normal(size=(64, 48)).astype(np.float32)

    with pytest.raises(ValueError):
        plan(spec, rhs_shape=(64, 48), tune="bogus")
    p_off = plan(spec, rhs_shape=(64, 48), tune="off", device="cpu")
    assert p_off.tuned is None
    p_cold = plan(spec, rhs_shape=(64, 48), device="cpu")
    assert p_cold.tuned is None
    p_meas = plan(spec, rhs_shape=(64, 48), tune="measure", device="cpu")
    assert isinstance(p_meas.tuned, tune.TunedConfig)
    tune.clear_memory_cache()
    p_warm = plan(spec, rhs_shape=(64, 48), device="cpu")
    assert p_warm.tuned == p_meas.tuned
    assert p_warm.lookup_tuned(48, device="cpu") == p_meas.tuned

    vals = torch.from_numpy(p_meas.pack(w))
    ref = p_off(torch.from_numpy(p_off.pack(w)), b)
    out = p_meas(vals, b)
    bound = p_meas.bind(vals, device="cpu")
    assert torch.equal(bound(b), out)
    explicit = ops.spmm(ops.PreparedOperand(
        p_meas.meta.fwd_idx, vals, (32, 64), 32), torch.from_numpy(b),
        variant=p_meas.tuned.variant, bn=p_meas.tuned.bn, device="cpu")
    assert torch.equal(out, explicit)
    np.testing.assert_allclose(ref.numpy(), w.T @ b, **TOL)
    np.testing.assert_allclose(out.numpy(), w.T @ b, **TOL)
    p_meas.check_feasible(48, device="cpu")
    p_meas.check_feasible(200, device="cpu")       # its order, own launch


def test_plan_tune_rejects_untunable_format():
    with pytest.raises(ValueError, match="no tunable"):
        plan(SparseSpec("dense")).tune(8, device="cpu")


def test_plan_rejects_a_stale_tuned_entry(caches):
    rng = np.random.default_rng(9)
    w = _sparse(rng, 64, 32, 0.3)
    spec = SparseSpec("incrs", mask=w != 0, section=32, block=8)
    p = plan(spec, device="cpu")
    idx = p.meta.fwd_idx
    key = tune.cache_key(*idx.shape, 32, 48, "cpu")
    tune._MEM[key] = _cfg(variant="reuse", geometry=(96, 2400), n_cols=48)
    with pytest.raises(L.KernelConfigError):
        plan(spec, rhs_shape=(64, 48), device="cpu")


# ----------------------------------------------------------------------
# The wave cost model's autotune seed.
def test_seed_from_autotune_matches_jax(caches):
    geo = (768, 47, 33, 256)
    points = [(128, 40.0), (256, 70.0), (512, 130.0)]
    for n, us in points:
        tune._store_disk(tune.cache_key(*geo, n, "cpu"), _cfg(us=us))
        jtune._store_disk(jtune.cache_key(*geo, n, "interpret"),
                          jtune.TunedConfig("expand", 128, 128, us, us))
    # an entry of another geometry and one of another backend: not points
    tune._store_disk(tune.cache_key(768, 47, 34, 256, 1024, "cpu"), _cfg())
    tune._store_disk(tune.cache_key(*geo, 1024, "cuda-sm90"), _cfg())
    tune.clear_memory_cache()
    port = tsched.seed_from_autotune(*geo, "cpu")
    jax_model = jsched.seed_from_autotune(*geo, "interpret")
    assert (port.us_per_col, port.launch_overhead_us, port.source) == \
        (jax_model.us_per_col, jax_model.launch_overhead_us,
         jax_model.source)
    assert port.source == "autotune[3 pts]"
    seeded = tsched.seed_cost_model(*geo, backend="cpu")
    assert seeded.source == "autotune[3 pts]"
    assert tsched.seed_from_autotune(768, 48, 33, 256, "cpu").source == \
        "unseeded"


def test_cpu_engine_seeds_from_its_own_entries(caches):
    from repro_torch.serve.engine import SpMMEngine
    rng = np.random.default_rng(10)
    inc = InCRS.from_dense(_sparse(rng, 40, 300, 0.2), section=64)
    eng = SpMMEngine(inc, max_wave_cols=128, device="cpu")
    assert eng.scheduler.cost.source == "unseeded"
    geo = eng._operand_geometry()
    for n, us in ((128, 30.0), (256, 50.0)):
        tune._store_disk(tune.cache_key(*geo, n, "cpu"), _cfg(us=us))
    eng = SpMMEngine(inc, max_wave_cols=128, device="cpu")
    assert eng.scheduler.cost.source == "autotune[2 pts]"
