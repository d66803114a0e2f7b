"""The training path on the card: the InCRS and BSR layers' products over
the transposed operands against the kernels' plain versions, their
gradients against float64, the launches of one training step, and the
example.

This file imports nothing of JAX, so it runs on a machine that has the card
and no JAX: ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_cuda_train.py`` (the shared conftest imports JAX). On a
machine without CUDA every test skips.

Tolerances: kernel against plain version ``1e-5 * max|C|``; gradients
against the float64 dense oracle ``1e-4 * max|g64|`` (f32 sums).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import train_unstructured as ex  # noqa: E402
from repro_torch.kernels import bsr_spmm as KB            # noqa: E402
from repro_torch.kernels import dense_mm as KD            # noqa: E402
from repro_torch.kernels import autotune                  # noqa: E402
from repro_torch.kernels import incrs_spmm as K           # noqa: E402
from repro_torch.kernels import ops                       # noqa: E402
from repro_torch.sparse import api                        # noqa: E402
from repro_torch.sparse import linear as lin_mod          # noqa: E402
from repro_torch.train import optimizer as opt            # noqa: E402

KERNEL_TOL = 1e-5
F64_TOL = 1e-4
SPECS = {"incrs": api.SparseSpec("incrs", density=0.1, section=64, block=8),
         "bsr": api.SparseSpec("bsr", density=0.3, block=64)}
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
    return {**K.LAUNCHES, **KB.LAUNCHES, **KD.LAUNCHES}


def _mlp(fmt, device, d_in=256, d_hid=512, d_out=128):
    rng = np.random.default_rng(0)
    return torch.nn.ModuleDict({
        name: api.Linear.from_dense(
            rng.normal(size=shape).astype(np.float32) * 0.05, SPECS[fmt],
            device=device)
        for name, shape in (("l1", (d_in, d_hid)), ("l2", (d_hid, d_out)))})


def _close(got, want, tol):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got.double() - want.double()).abs().max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [512, 77])
def test_incrs_dx_kernel_matches_plain_on_transposed_stripes(cuda, t):
    p = _mlp("incrs", cuda)["l2"].inner
    m = p.meta
    flat = torch.cat([p.values.detach().reshape(-1),
                      p.values.new_zeros(1)])
    tvals = flat.index_select(0, m.t_gather).view(m.bwd_idx.shape)
    kp = m.bwd_idx.shape[1] * m.section
    dyt = torch.zeros(kp, 512, device=cuda)
    dyt[:m.d_out, :t] = torch.randn(m.d_out, t, device=cuda)
    out = K.incrs_spmm(m.bwd_idx, tvals, dyt, section=m.section, bn=512)
    ref = K.plain("incrs_spmm", m.bwd_idx, tvals, dyt, section=m.section,
                  bn=512)
    _close(out, ref, KERNEL_TOL)
    want = torch.from_numpy(lin_mod.incrs_to_dense_weight(p).astype(
        np.float64)).to(cuda)
    _close(out[:m.d_in], want @ dyt[:m.d_out].double(), F64_TOL)


@pytest.mark.gpu
def test_bsr_dx_kernel_matches_plain_on_transposed_lists(cuda):
    p = _mlp("bsr", cuda)["l2"].inner
    m = p.meta
    gi = m.grad_index(cuda)
    slots = lin_mod._scatter_slots(
        p.values.detach().index_select(0, gi.t_perm).transpose(1, 2),
        gi.t_vpos, len(m.t_col_of))
    row_of, col_of, row_start = m.kernel_index_t(cuda)
    dyt = torch.randn(m.d_out, 300, device=cuda)
    out = KB.bsr_spmm(row_of, col_of, slots, dyt,
                      n_block_rows=m.n_block_rows_t, row_start=row_start)
    ref = KB.plain(row_of, col_of, slots, dyt, n_block_rows=m.n_block_rows_t)
    _close(out, ref, KERNEL_TOL)
    want = torch.from_numpy(lin_mod.to_dense(p).astype(np.float64)).to(cuda)
    _close(out, want @ dyt.double(), F64_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["incrs", "bsr"])
def test_gradients_match_float64(cuda, fmt):
    model = _mlp(fmt, cuda)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(512, 256)).astype(np.float32)
                         ).to(cuda)
    y = torch.from_numpy(rng.normal(size=(512, 128)).astype(np.float32)
                         ).to(cuda)
    errs = ex.grad_errors(model, x, y)
    assert all(e <= F64_TOL for e in errs.values()), errs


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["incrs", "bsr"])
def test_a_step_launches_three_kernels_of_its_format(cuda, fmt,
                                                    monkeypatch, tmp_path):
    """Two forwards and l2's dx (x needs no gradient, so l1 has no dx), of
    the format's kernel (incrs: the orders ``auto`` picks, the tuning
    cache empty); no other kernel. Pad slots and zero tiles stay 0.0."""
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "tune.json"))
    autotune.clear_memory_cache()
    model = _mlp(fmt, cuda)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(256, 256)).astype(np.float32)
                         ).to(cuda)
    y = torch.from_numpy(rng.normal(size=(256, 128)).astype(np.float32)
                         ).to(cuda)
    cfg = opt.AdamWConfig(lr=3e-3, weight_decay=0.0, warmup_steps=1,
                          total_steps=4)
    state = opt.adamw_init(cfg, dict(model.named_parameters()))
    before = _counts()
    losses = []
    for _ in range(4):
        loss, state, _ = ex.train_step(cfg, model, state, x, y)
        losses.append(float(loss))
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in _counts().items()
             if v != before[k]}
    want = step_kernels(model, 256, 4) if fmt == "incrs" else \
        {FORMAT_KERNEL[fmt]: 12}
    assert moved == want and sum(want.values()) == 12, moved
    assert losses[-1] < losses[0]
    if fmt == "incrs":
        for lin in model.values():
            pad = lin.meta.fwd_idx < 0
            assert bool((lin.values.detach()[pad] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["incrs", "bsr"])
def test_example_trains_and_serves_on_the_card(cuda, fmt):
    out = ex.main(["--format", fmt, "--steps", "20"])
    assert out["losses"][-1] < out["losses"][0]
    assert out["served_err"] <= ex.SERVE_TOL
