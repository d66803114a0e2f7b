"""The tuning layer on the card: sweeps, the picks' launches, the launch
check's occupancy rule.

Each sweep's measured candidates must give C bitwise equal to expand's
(the three orders sum in one order) and within ``1e-5 * max|C|`` of the
plain version; ``ops.spmm(variant="auto")``, a tuned plan and an engine
must launch the winner's kernel, at its geometry, once a call or wave, and
no other; with no entry, the cost model's order. Every wrapper's
occupancy on the card must hold the CTAs an SM the wrapper counts on.

No JAX import: ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_cuda_autotune.py``. Every test skips without CUDA.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import launch_check as L        # noqa: E402
from repro_torch.core.incrs import InCRS                  # noqa: E402
from repro_torch.data import datasets                     # noqa: E402
from repro_torch.kernels import autotune                  # noqa: E402
from repro_torch.kernels import incrs_spmm as K           # noqa: E402
from repro_torch.kernels import index_match_spmm as IM    # noqa: E402
from repro_torch.kernels import ops                       # noqa: E402
from repro_torch.serve import engine as E                 # noqa: E402
from repro_torch.sparse import SparseSpec                 # noqa: E402
from repro_torch.sparse.api import plan                   # noqa: E402

KERNEL_TOL = 1e-5
NAME = {"expand": "incrs_spmm", "reuse": "incrs_spmm_reuse",
        "pipelined": "incrs_spmm_pipelined"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def cache(monkeypatch, tmp_path):
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "tune.json"))
    autotune.clear_memory_cache()
    yield tmp_path / "tune.json"
    autotune.clear_memory_cache()


@pytest.fixture
def launched(monkeypatch):
    """Every InCRS launch's (kernel, geometry), recorded at the one place
    that launches."""
    seen = []
    real = K._launch

    def record(name, idx, val, b, section, geometry=None):
        out = real(name, idx, val, b, section, geometry)
        seen.append((name, None if geometry is None else tuple(geometry)))
        return out
    monkeypatch.setattr(K, "_launch", record)
    return seen


def _docword():
    spec = datasets.scaled(datasets.TABLE2_DATASETS["docword"], 0.2)
    return InCRS.from_crs(datasets.synthesize(spec, 0))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [128, 512])
def test_sweep_candidates_are_bitwise_equal_and_auto_rides_the_winner(
        cuda, cache, launched, n):
    inc = _docword()
    prep = ops.prepare_incrs(inc, device=cuda)
    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.normal(size=(inc.shape[1], n)).astype(
        np.float32)).to(cuda)
    kp = prep.n_sections * prep.section
    bp = torch.nn.functional.pad(b, (0, -(-n // ops.default_bn(n)) *
                                     ops.default_bn(n) - n,
                                     0, kp - b.shape[0]))
    want = K.incrs_spmm(prep.idx, prep.val, bp, section=prep.section,
                        bn=ops.default_bn(n))
    ref = K.plain("incrs_spmm", prep.idx, prep.val, bp, section=prep.section,
                  bn=ops.default_bn(n))
    scale = float(ref.abs().max())
    checked = []

    def verify(variant, geo, out):
        assert torch.equal(out, want), (variant, geo)
        assert float((out - ref).abs().max()) <= KERNEL_TOL * scale
        checked.append(variant)

    cfg = autotune.tune(prep.idx, prep.val, b, section=prep.section,
                        reps=5, top_k=None, verify=verify)
    rec = autotune.LAST_SWEEP
    assert len(rec.measured) == len(checked) >= 3
    assert set(checked) == set(NAME)
    assert cfg.geometry is not None and cfg.n_cols == n
    launched.clear()
    out = ops.spmm(inc, b, device=cuda)
    torch.cuda.synchronize()
    assert launched == [(NAME[cfg.variant], cfg.geometry)]
    assert torch.equal(out, want[:inc.shape[0], :n])


@pytest.mark.gpu
def test_auto_without_an_entry_launches_the_model_pick(cuda, cache,
                                                       launched):
    inc = _docword()
    prep = ops.prepare_incrs(inc, device=cuda)
    b = torch.ones((inc.shape[1], 384), device=cuda)
    pick = autotune.model_pick_variant(
        prep.padded_rows, 384, n_sections=prep.n_sections,
        smax=prep.idx.shape[2], section=prep.section)
    ops.spmm(prep, b)
    torch.cuda.synchronize()
    assert launched == [(NAME[pick], None)]


@pytest.mark.gpu
def test_tuned_plan_and_engine_launch_the_winner(cuda, cache, launched):
    rng = np.random.default_rng(1)
    w = np.where(rng.random((2048, 1024)) < 0.05,
                 rng.normal(size=(2048, 1024)), 0.0).astype(np.float32)
    spec = SparseSpec("incrs", mask=w != 0)
    p = plan(spec, rhs_shape=(2048, 512), tune="measure", device=cuda)
    cfg = p.tuned
    assert cfg is not None and cfg.n_cols == 512
    bound = p.bind(p.pack(w), device=cuda)
    launched.clear()
    b = torch.from_numpy(rng.normal(size=(2048, 512)).astype(
        np.float32)).to(cuda)
    out = bound(b)
    assert launched == [(NAME[cfg.variant], cfg.geometry)]
    assert plan(spec, rhs_shape=(2048, 512), device=cuda).tuned == cfg
    eng = E.SpMMEngine(bound, max_wave_cols=512, device=cuda)
    assert eng.scheduler.cost.source == "autotune[1 pts]"
    launched.clear()
    panels = [rng.normal(size=(2048, 512)).astype(np.float32)
              for _ in range(3)]
    for i, p_ in enumerate(panels):
        eng.submit(E.SpMMRequest(i, p_))
    done = {r.rid: r for r in eng.run()}
    assert launched == [(NAME[cfg.variant], cfg.geometry)] * \
        eng.stats["waves"] and eng.stats["waves"] == 3
    want = w.T.astype(np.float64) @ panels[0].astype(np.float64)
    assert np.abs(done[0].out - want).max() <= 1e-4 * np.abs(want).max()
    assert torch.equal(out, bound(b))


@pytest.mark.gpu
def test_index_match_sweep_and_its_launch(cuda, cache):
    spec = datasets.scaled(datasets.TABLE4_DATASETS["docword4"], 0.2)
    a = datasets.synthesize(spec, 0)
    want = None

    def verify(rounds, geo, out):
        nonlocal want
        c = out[:a.shape[0], :a.shape[0]]
        if want is None:
            want = ops.spmm(a, a, variant="reference", rounds=128,
                            device=cuda)
        assert float((c - want).abs().max()) <= \
            1e-5 * float(want.abs().max())

    cfg = autotune.tune_index_match(a, a, device=cuda, reps=3, top_k=None,
                                    verify=verify)
    assert cfg.rounds in autotune.MATCHED_ROUNDS
    before = dict(IM.INSTANCE_LAUNCHES)
    out = ops.spmm(a, a, variant="reference", device=cuda)
    torch.cuda.synchronize()
    inst = cfg.launch_geometry.instance
    assert IM.INSTANCE_LAUNCHES[f"index_match_spmm/{inst}"] == \
        before[f"index_match_spmm/{inst}"] + 1
    assert float((out - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _shapes():
    docword = dict(m=768, n=512, n_sections=47, smax=33, section=256)
    out = [(k, docword) for k in NAME.values()]
    out += [(k, dict(docword, **kn)) for k, kn in (
        ("incrs_spmm", {"rows": 1}), ("incrs_spmm_reuse", {"tpr": 32}),
        ("incrs_spmm_pipelined", {"cluster": 1, "cols_per_lane": 1,
                                  "warps": 8}))]
    out += [(k, dict(m=24576, n=512, n_sections=24, smax=51, section=256))
            for k in NAME.values()]
    out += [("incrs_gather", dict(m=1504, n_sections=47, smax=77,
                                  section=256)),
            ("incrs_gather", dict(m=1504, n_sections=47, smax=77,
                                  section=256, instance="general"))]
    for kernel in ("index_match_spmm", "spgemm_condense"):
        for inst in ("ring", "general"):
            out.append((kernel, dict(m=1536, n=1536, n_rounds=94, rmax_a=45,
                                     rmax_b=45, rounds=128, instance=inst)))
    out += [("spgemm_merge", dict(plane=1500 * 1500, n_rounds=94)),
            ("spgemm_merge", dict(plane=1500 * 1500, n_rounds=94,
                                  instance="general"))]
    for dt in (torch.float32, torch.bfloat16):
        out += [("dense_mm", dict(m=24576, n=512, k=6144, dtype=dt)),
                ("dense_mm", dict(m=128, n=128, k=6144, dtype=dt)),
                ("dense_mm", dict(m=100, n=30, k=70, dtype=dt)),
                ("bsr_spmm", dict(n_block_rows=192, bm=128, bk=128, n=512,
                                  nnz=2304, dtype=dt)),
                ("bsr_spmm", dict(n_block_rows=14, bm=50, bk=50, n=512,
                                  nnz=300, dtype=dt)),
                ("flash_attention", dict(batch=2, sq=8192, sk=8192, kv=1,
                                         g=48, hd=128, dtype=dt))]
    out.append(("flash_attention", dict(batch=1, sq=512, sk=512, kv=2, g=4,
                                        hd=256, dtype=torch.bfloat16)))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("case", _shapes(),
                         ids=[f"{k}-{i}" for i, (k, _) in
                              enumerate(_shapes())])
def test_occupancy_rule_agrees_with_the_card(cuda, case):
    kernel, shape = case
    rep = L.launch_report(kernel, on_card=True, **shape)
    assert rep.violations == [], rep.violations
    assert rep.card_ctas is not None and rep.card_ctas >= \
        max(1, rep.assumed_ctas)
    assert rep.registers is not None        # the build's ptxas log
