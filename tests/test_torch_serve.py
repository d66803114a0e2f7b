"""The port's SpMM serving (scheduler, engine, launcher) against the JAX
package's, on the CPU. Outputs agree within rtol = atol = 1e-4 (another
f32 summation order); the wave schedule and its statistics are equal."""
from collections import deque

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401

torch = pytest.importorskip("torch")

from repro.core.incrs import InCRS as JInCRS              # noqa: E402
from repro.data import datasets as jdata                  # noqa: E402
from repro.serve import engine as jeng                    # noqa: E402
from repro.serve import scheduler as jsched               # noqa: E402
from repro_torch import convert                           # noqa: E402
from repro_torch.kernels import ops as tops               # noqa: E402
from repro_torch.serve import engine as teng              # noqa: E402
from repro_torch.serve import scheduler as tsched         # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _operand():
    spec = jdata.scaled(jdata.TABLE2_DATASETS["docword"], 0.06)
    j = JInCRS.from_crs(jdata.synthesize(spec, 0))
    t = convert.incrs_from_arrays(j.crs.values, j.crs.col_idx, j.crs.row_ptr,
                                  j.shape, j.counters, j.section, j.block)
    return j, t


def _trace(k, cap):
    """The mixed-width trace of examples/spmm_serve.py at --batch-cols
    cap//2, plus one request wider than the wave cap."""
    rng = np.random.default_rng(1)
    bc = cap // 2
    widths = [(bc, bc // 2, bc // 4, bc + bc // 2)[r % 4] for r in range(8)]
    widths.append(cap * 2 + 40)
    return [rng.normal(size=(k, w)).astype(np.float32) for w in widths]


@pytest.mark.parametrize("continuous", [True, False])
def test_engine_matches_jax_engine(continuous):
    j, t = _operand()
    cap = 256
    panels = _trace(j.shape[1], cap)
    # An explicit variant: JAX "auto" may pick the pipelined kernel, which
    # does not trace on the installed jax (ROADMAP fault C1).
    je = jeng.SpMMEngine(j, max_wave_cols=cap, variant="expand",
                         continuous=continuous)
    te = teng.SpMMEngine(t, max_wave_cols=cap, variant="expand",
                         device="cpu", continuous=continuous)
    for eng, cls in ((je, jeng.SpMMRequest), (te, teng.SpMMRequest)):
        for i, p in enumerate(panels):
            eng.submit(cls(i, p))
        eng.run()
    dense = j.crs.to_dense()
    jout = {r.rid: r.out for r in je.finished}
    assert sorted(r.rid for r in te.finished) == sorted(jout)
    for r in te.finished:
        assert r.done and r.out.dtype == np.float32
        np.testing.assert_allclose(r.out, jout[r.rid], **TOL)
        np.testing.assert_allclose(r.out, dense @ r.b, **TOL)
    for key in ("waves", "split_requests", "split_parts", "pad_cols",
                "requests", "cols"):
        assert te.stats[key] == je.stats[key], key
    ts, js = te.stats_summary(), je.stats_summary()
    assert sorted(ts) == sorted(js)
    assert ts["mode"] == js["mode"] and ts["waves"] == js["waves"]
    assert ts["cost_model"]["n_observed"] == ts["waves"]


class _Stub:
    def __init__(self, w):
        self.b = np.empty((1, w), np.float32)


@pytest.mark.parametrize("skip_limit", [0, 1, 3, 8])
@pytest.mark.parametrize("budget", [None, 300.0, 2000.0])
def test_wave_packer_matches_jax(skip_limit, budget):
    rng = np.random.default_rng(skip_limit + int(budget or 0))
    widths = [int(w) for w in rng.integers(1, 200, size=60)]
    waves = []
    for mod in (jsched, tsched):
        cost = mod.WaveCostModel(us_per_col=2.0, launch_overhead_us=50.0)
        packer = mod.WavePacker(cost=cost, budget_us=budget,
                                skip_limit=skip_limit)
        stubs = [_Stub(w) for w in widths]
        ids = {id(s): i for i, s in enumerate(stubs)}
        q = deque(stubs)
        seq = []
        while q:
            seq.append([ids[id(r)] for r in packer.next_wave(q, 256)])
            packer.observe(sum(widths[i] for i in seq[-1]), 700.0)
        waves.append((seq, packer.last_target, cost.us_per_col))
    assert waves[0] == waves[1]


def test_cost_model_fit_matches_jax():
    for pts in ([], [(100, 1100.0)], [(100, 1100.0), (300, 3100.0)],
                [(100, 900.0), (300, 400.0)], [(64, 80.0), (128, 100.0),
                                               (512, 300.0)]):
        assert tsched.fit_us_per_col(pts) == jsched.fit_us_per_col(pts)


def test_swap_pattern_rejects_shape_change_and_keeps_serving():
    j, t = _operand()
    eng = teng.SpMMEngine(t, max_wave_cols=128, variant="reuse",
                          device="cpu")
    old = eng.prep
    wrong = convert.incrs_from_arrays(j.crs.values, j.crs.col_idx,
                                      j.crs.row_ptr,
                                      (j.shape[0], j.shape[1] + 300),
                                      np.zeros((j.shape[0], 4, 2), np.uint32),
                                      256, 32)
    with pytest.raises(ValueError, match="swap_pattern"):
        eng.swap_pattern(wrong)
    assert eng.prep is old and eng.stats["pattern_swaps"] == 0
    rng = np.random.default_rng(4)
    b = rng.normal(size=(t.shape[1], 40)).astype(np.float32)
    eng.submit(teng.SpMMRequest(0, b))
    eng.step(retire=False)                 # wave 0 in flight on the old A
    half = j.crs.to_dense()
    half[:, ::2] = 0.0
    new = convert.incrs_from_arrays(*_fields(JInCRS.from_dense(half)))
    eng.swap_pattern(new)
    assert eng.stats["pattern_swaps"] == 1
    eng.submit(teng.SpMMRequest(1, b))
    done = {r.rid: r for r in eng.run()}
    np.testing.assert_allclose(done[0].out, j.crs.to_dense() @ b, **TOL)
    np.testing.assert_allclose(done[1].out, half @ b, **TOL)


def _fields(j):
    return (j.crs.values, j.crs.col_idx, j.crs.row_ptr, j.shape, j.counters,
            j.section, j.block)


def test_engine_validates_and_keeps_request_dtypes():
    _, t = _operand()
    eng = teng.SpMMEngine(tops.prepare_incrs(t, device="cpu"),
                          max_wave_cols=256, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        eng.submit(teng.SpMMRequest(0, np.zeros((3, 4), np.float32)))
    rng = np.random.default_rng(6)
    b16 = rng.normal(size=(t.shape[1], 16)).astype(np.float16)
    b32 = rng.normal(size=(t.shape[1], 24)).astype(np.float32)
    eng.submit(teng.SpMMRequest(0, b16))
    eng.submit(teng.SpMMRequest(1, b32))
    done = {r.rid: r for r in eng.run()}
    assert done[0].out.dtype == np.float16
    assert done[1].out.dtype == np.float32
    dense = t.crs.to_dense()
    np.testing.assert_allclose(done[1].out, dense @ b32, **TOL)
    eng.submit(teng.SpMMRequest(2, b32.astype(np.float64)))
    with pytest.warns(UserWarning, match="f32 accumulation"):
        eng.run()
    from repro_torch.launch.mesh import make_mesh      # ported: item 8
    sharded = teng.SpMMEngine(t, device="cpu", mesh=make_mesh(4, "cpu"))
    assert sharded.sharded
    sharded.submit(teng.SpMMRequest(3, b32))
    np.testing.assert_array_equal(sharded.run()[0].out, done[1].out)
    with pytest.raises(ValueError, match="re-shard"):
        teng.SpMMEngine(tops.prepare_incrs(t, device="cpu"), device="cpu",
                        mesh=make_mesh(4, "cpu"))
    with pytest.raises(TypeError, match="BoundPlan"):
        teng.SpMMEngine(object(), device="cpu")
    with pytest.raises(ValueError, match="variant"):
        teng.SpMMEngine(t, device="cpu", variant="fastest")


def test_launcher_serves_on_cpu(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--spmm", "--workload", "incrs-docword", "--scale",
                     "0.06", "--device", "cpu", "--n-requests", "3"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "single-device cpu" in out
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--arch", "no-such-arch"])
