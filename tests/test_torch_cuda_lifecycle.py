"""The crs plan and the sparsity lifecycle on the card: the plan's three
routes against the same plan on the CPU (the kernels' plain versions),
and a repack -> hot swap -> training step of small layers.

This file imports nothing of JAX, so it runs on a machine that has the card
and no JAX: ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_cuda_lifecycle.py`` (the shared conftest imports JAX). On
a machine without CUDA every test skips.

Tolerances: kernel against plain version ``1e-5 * max|C|``; served results
and gradients against float64 ``1e-4 * max|ref|`` (f32 sums).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.crs import CRS                      # noqa: E402
from repro_torch.core.incrs import InCRS                  # noqa: E402
from repro_torch.examples import train_reprune            # noqa: E402
from repro_torch.examples import train_unstructured as ex  # noqa: E402
from repro_torch.kernels import bsr_spmm as KB            # noqa: E402
from repro_torch.kernels import autotune                  # noqa: E402
from repro_torch.kernels import incrs_spmm as K           # noqa: E402
from repro_torch.kernels import index_match_spmm as IM    # noqa: E402
from repro_torch.kernels import ops                       # noqa: E402
from repro_torch.serve import engine as E                 # noqa: E402
from repro_torch.sparse import api                        # noqa: E402
from repro_torch.sparse import pattern as spat            # noqa: E402
from repro_torch.spgemm import kernels as SK              # noqa: E402
from repro_torch.train import optimizer as opt            # noqa: E402
from repro_torch.train import trainer                     # noqa: E402

KERNEL_TOL = 1e-5
F64_TOL = 1e-4
ROUTES = {None: {"index_match_spmm": 1},
          "crs": {"spgemm_condense": 1, "spgemm_merge": 1},
          "incrs": {"spgemm_condense": 1, "spgemm_merge": 1}}
SPECS = {"incrs": dict(density=0.1, section=64, block=8),
         "bsr": dict(density=0.3, block=64)}
FORMAT_KERNEL = {"incrs": "incrs_spmm", "bsr": "bsr_spmm"}
ORDER_KERNEL = {"expand": "incrs_spmm", "reuse": "incrs_spmm_reuse",
                "pipelined": "incrs_spmm_pipelined"}


def step_kernels(model, t, steps):
    """The InCRS kernel launches of ``steps`` steps on t token rows: each
    product's ``auto`` order (l1's and l2's forward stripes, l2's
    transposed stripes for dx), once a step."""
    l1, l2 = model["l1"].meta, model["l2"].meta
    want = {}
    for idx, k in ((l1.fwd_idx, l1.d_in), (l2.fwd_idx, l2.d_in),
                   (l2.bwd_idx, l2.d_out)):
        prep = ops.PreparedOperand(idx, idx, (idx.shape[0], k), l1.section)
        name = ORDER_KERNEL[ops.resolve_incrs(prep, t)[0]]
        want[name] = want.get(name, 0) + steps
    return want


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _counts():
    return {k: v for k, v in {**K.LAUNCHES, **KB.LAUNCHES, **IM.LAUNCHES,
                              **SK.LAUNCHES}.items()}


def _moved(before):
    return {k: v - before[k] for k, v in _counts().items() if v != before[k]}


def _close(got, want, tol):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got.double() - want.double()).abs().max())
    assert err <= tol * scale, (err, scale)


def _sparse(m, k, density, seed):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((m, k)) < density,
                    rng.normal(size=(m, k)), 0.0).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("rhs_format", list(ROUTES))
@pytest.mark.parametrize("rounds", [32, 128])
def test_crs_plan_routes_match_their_plain_versions(cuda, rhs_format,
                                                    rounds):
    a = _sparse(600, 1000, 0.08, 1)
    bt = _sparse(300, 1000, 0.03, 2)
    bt[7, :rounds] = 1.0                 # a dense window: B's rmax differs
    spec = api.SparseSpec("crs", rounds=rounds, rhs_format=rhs_format)
    on_card = api.plan_for_operand(a, spec, device=cuda)
    on_cpu = api.plan_for_operand(a, spec, device="cpu")
    rhs = CRS.from_dense(bt)
    if rhs_format == "incrs":
        rhs = InCRS.from_crs(rhs)
    before = _counts()
    got = on_card(rhs)
    again = on_card(rhs)                 # a memo hit of the RHS prep
    torch.cuda.synchronize()
    assert _moved(before) == {k: 2 * v for k, v in
                              ROUTES[rhs_format].items()}
    assert got.device.type == "cuda" and got.shape == (600, 300)
    assert torch.equal(got, again)
    assert torch.equal(got, on_card(rhs, variant="reference"))
    want = on_cpu(rhs)
    _close(got.cpu(), want, KERNEL_TOL)
    _close(got.cpu(), torch.from_numpy(a.astype(np.float64) @
                                       bt.T.astype(np.float64)), F64_TOL)


@pytest.mark.gpu
def test_crs_plan_refuses_stripes_that_do_not_fit(cuda, monkeypatch):
    a = _sparse(256, 512, 0.1, 3)
    bound = api.plan_for_operand(a, api.SparseSpec("crs", rounds=32,
                                                   rhs_format="crs"),
                                 device=cuda)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (0, 0))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 0)
    with pytest.raises(RuntimeError, match="stripe array"):
        bound(CRS.from_dense(_sparse(64, 512, 0.1, 4)))


def _student(fmt, device):
    rng = np.random.default_rng(5)
    spec = api.SparseSpec(fmt, **SPECS[fmt])
    return torch.nn.ModuleDict({
        name: api.Linear.from_dense(
            rng.normal(size=shape).astype(np.float32) * 0.05, spec,
            device=device)
        for name, shape in (("l1", (256, 512)), ("l2", (512, 128)))})


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["incrs", "bsr"])
def test_repack_swap_and_step_on_the_card(cuda, fmt, monkeypatch, tmp_path):
    """incrs launches the orders ``auto`` picks (the tuning cache
    empty): the wave after the swap one of the new stripes' at its width,
    a step one each of its three products'."""
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "tune.json"))
    autotune.clear_memory_cache()
    model = _student(fmt, cuda)
    l1 = model["l1"]
    cfg = opt.AdamWConfig(lr=1e-2, weight_decay=0.0, warmup_steps=0,
                          total_steps=10)
    state = opt.adamw_init(cfg, dict(model.named_parameters()))
    eng = E.SpMMEngine(l1, max_wave_cols=256)
    rng = np.random.default_rng(6)
    b_old = rng.normal(size=(256, 64)).astype(np.float32)
    w_old = torch.from_numpy(l1.to_dense()).double()
    eng.submit(E.SpMMRequest(0, b_old))
    eng.step(retire=False)               # in flight across the swap
    cb = trainer.make_prune_callback(spat.PruneSchedule(
        SPECS[fmt]["density"] / 2, 1, warmup_frac=0.0))
    info = cb(1, model, state)
    assert info is not None and info["layers"] == 2
    assert l1.values.device.type == "cuda" and l1.pattern.version == 1
    if fmt == "incrs":
        assert l1.meta.fwd_idx.device.type == "cuda"
        assert l1.meta.t_gather.device.type == "cuda"
    before = _counts()
    eng.swap_pattern(l1)
    assert eng.pattern_version == 1
    b_new = rng.normal(size=(256, 96)).astype(np.float32)
    eng.submit(E.SpMMRequest(1, b_new))
    done = {r.rid: r for r in eng.run()}
    kname = FORMAT_KERNEL[fmt]
    if fmt == "incrs":                   # the wave: 96 columns, in 128
        kname = ORDER_KERNEL[ops.resolve_incrs(eng.prep._ready, 128)[0]]
    assert _moved(before) == {kname: 1}  # the wave after the swap
    _close(torch.from_numpy(done[0].out), w_old.T @ torch.from_numpy(
        b_old).double(), F64_TOL)
    w_new = torch.from_numpy(l1.to_dense()).double()
    _close(torch.from_numpy(done[1].out), w_new.T @ torch.from_numpy(
        b_new).double(), F64_TOL)
    x = torch.randn(64, 256, device=cuda)
    y = torch.randn(64, 128, device=cuda)
    errs = ex.grad_errors(model, x, y)
    assert max(errs.values()) <= F64_TOL, errs
    before = _counts()
    loss, state, _ = ex.train_step(cfg, model, state, x, y)
    torch.cuda.synchronize()
    assert _moved(before) == (step_kernels(model, 64, 1) if fmt == "incrs"
                              else {kname: 3})
    assert bool(torch.isfinite(loss))
    assert state["m"]["l1.values"].shape == l1.values.shape
    assert state["m"]["l1.values"].device.type == "cuda"
    if fmt == "incrs":
        assert bool((l1.values.detach()[l1.meta.fwd_idx < 0] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["incrs", "bsr"])
def test_a_training_step_does_not_reach_the_served_operand(cuda, fmt):
    model = _student(fmt, cuda)
    l1 = model["l1"]
    eng = E.SpMMEngine(l1, max_wave_cols=256)
    rng = np.random.default_rng(7)
    w0 = torch.from_numpy(l1.to_dense()).double()

    def serve(rid, w):
        b = rng.normal(size=(256, 64)).astype(np.float32)
        eng.submit(E.SpMMRequest(rid, b))
        out = [r for r in eng.run() if r.rid == rid][0].out
        _close(torch.from_numpy(out), w.T @ torch.from_numpy(b).double(),
               F64_TOL)

    serve(0, w0)
    cfg = opt.AdamWConfig(lr=1e-2, weight_decay=0.0, warmup_steps=0,
                          total_steps=10)
    state = opt.adamw_init(cfg, dict(model.named_parameters()))
    x = torch.randn(64, 256, device=cuda)
    y = torch.randn(64, 128, device=cuda)
    _, state, _ = ex.train_step(cfg, model, state, x, y)
    w1 = torch.from_numpy(l1.to_dense()).double()
    assert not torch.equal(w1, w0)         # the step moved the weight
    serve(1, w0)                           # the engine serves its copy
    eng.swap_pattern(l1)
    serve(2, w1)


@pytest.mark.gpu
def test_the_reprune_example_runs_on_the_card(cuda):
    out = train_reprune.main(["--device", "cuda", "--steps", "12"])
    assert out["version"] > 0 and out["swaps"] == 1
