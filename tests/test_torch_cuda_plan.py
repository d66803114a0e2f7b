"""The port's BSR and dense kernels on the card: each against its plain
torch version and the float64 product on edge operands, the wrappers'
refusals, and bsr / dense plans served one kernel launch per wave.

This file imports nothing of JAX, so it runs on a machine that has the card
and no JAX: ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_cuda_plan.py`` (the shared conftest imports JAX). On a
machine without CUDA every test skips.

Tolerances: kernel against plain version ``1e-5 * max|C|`` (the plain
versions sum in another order); against the float64 product
``1e-4 * max|C|`` (f32 accumulation).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import sparse                            # noqa: E402
from repro_torch.core.bsr import BSR                      # noqa: E402
from repro_torch.kernels import bsr_spmm as KB            # noqa: E402
from repro_torch.kernels import dense_mm as KD            # noqa: E402
from repro_torch.kernels import ops                       # noqa: E402
from repro_torch.serve import engine as E                 # noqa: E402

KERNEL_TOL = 1e-5
F64_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _bsr_operand(m, k, bm, bk, density, empty_rows=(), seed=0):
    rng = np.random.default_rng(seed)
    nbr, nbc = m // bm, k // bk
    keep = rng.random((nbr, nbc)) < density
    keep[list(empty_rows)] = False
    a = rng.normal(size=(m, k)).astype(np.float32)
    a = (a.reshape(nbr, bm, nbc, bk) * keep[:, None, :, None]).reshape(m, k)
    return BSR.from_mask(a, keep, (bm, bk)), a


# (label, m, k, bm, bk, density, empty block-rows, N)
BSR_CASES = [
    ("block10", 120, 300, 10, 10, 0.6, (), 512),
    ("block50_empty_rows", 300, 500, 50, 50, 0.5, (1, 4), 129),
    ("block60_n1", 240, 360, 60, 60, 0.7, (), 1),
    ("rect_32x64", 256, 512, 32, 64, 0.4, (0,), 96),
    ("block128", 512, 384, 128, 128, 0.5, (), 200),
    ("bm_above_128", 400, 200, 200, 100, 0.9, (), 33),
    ("all_empty", 128, 128, 32, 32, 0.0, (), 64),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", BSR_CASES, ids=lambda c: c[0])
def test_bsr_kernel_matches_plain_and_float64(cuda, case):
    label, m, k, bm, bk, density, empty, n = case
    bsr, a = _bsr_operand(m, k, bm, bk, density, empty)
    row_of, col_of, values, rs = ops.prep_bsr(bsr, device=cuda)
    b = torch.from_numpy(np.random.default_rng(1).normal(
        size=(k, n)).astype(np.float32)).to(cuda)
    before = KB.LAUNCHES["bsr_spmm"]
    out = KB.bsr_spmm(row_of, col_of, values, b,
                      n_block_rows=bsr.n_block_rows, row_start=rs)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["bsr_spmm"] == before + 1
    ref = KB.plain(row_of, col_of, values, b, n_block_rows=bsr.n_block_rows)
    assert out.shape == (m, n) and bool(torch.isfinite(out).all())
    want = a.astype(np.float64) @ b.cpu().numpy().astype(np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float((out - ref).abs().max()) <= KERNEL_TOL * scale
    assert np.abs(out.cpu().numpy() - want).max() <= F64_TOL * scale
    if density == 0.0:
        assert not bool(out.any())
    got = ops.spmm(bsr, b)                        # prep + kernel, one call
    assert float((got - out).abs().max()) <= KERNEL_TOL * scale


@pytest.mark.gpu
def test_bsr_kernel_writes_zeros_for_an_empty_run(cuda):
    """Without the zero tiles of prep: an empty run still writes C."""
    bsr, a = _bsr_operand(96, 64, 32, 32, 0.8, empty_rows=(1,))
    rs = KB.block_row_starts(np.repeat(np.arange(3), np.diff(bsr.row_ptr)),
                             3)
    row_of = np.concatenate([np.repeat(np.arange(3), np.diff(bsr.row_ptr)),
                             [2]]).astype(np.int32)
    b = torch.ones((64, 8), device=cuda)
    out = KB.bsr_spmm(torch.from_numpy(row_of).to(cuda),
                      torch.from_numpy(bsr.col_idx).to(cuda),
                      torch.from_numpy(bsr.values).to(cuda), b,
                      n_block_rows=3,
                      row_start=torch.from_numpy(rs).to(cuda))
    torch.cuda.synchronize()
    assert not bool(out[32:64].any())
    np.testing.assert_allclose(out.cpu().numpy(), a @ np.ones((64, 8)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1, 1), (127, 129, 300),
                                   (300, 7, 129), (256, 512, 384),
                                   (33, 1000, 5)],
                         ids=lambda s: "x".join(map(str, s)))
def test_dense_kernel_matches_plain_and_float64(cuda, shape):
    m, k, n = shape
    rng = np.random.default_rng(2)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    at, bt = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    before = KD.LAUNCHES["dense_mm"]
    out = ops.dense_mm(at, bt)
    torch.cuda.synchronize()
    assert KD.LAUNCHES["dense_mm"] == before + 1
    want = a.astype(np.float64) @ b.astype(np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    ref = KD.plain(at, bt)
    assert out.shape == (m, n) and out.dtype == torch.float32
    assert float((out - ref).abs().max()) <= KERNEL_TOL * scale
    assert np.abs(out.cpu().numpy() - want).max() <= F64_TOL * scale


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    bsr, _ = _bsr_operand(64, 64, 16, 16, 0.5)
    row_of, col_of, values, rs = ops.prep_bsr(bsr, device=cuda)
    b = torch.zeros((64, 8), device=cuda)
    kw = dict(n_block_rows=4, row_start=rs)
    with pytest.raises(TypeError, match="bf16 is a later mode"):
        KB.bsr_spmm(row_of, col_of, values.bfloat16(), b.bfloat16(), **kw)
    with pytest.raises(TypeError, match="bf16 is a later mode"):
        KB.bsr_spmm(row_of, col_of, values, b.half(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        KB.bsr_spmm(row_of, col_of, values,
                    torch.zeros((8, 64), device=cuda).T, **kw)
    with pytest.raises(ValueError, match="share one device"):
        KB.bsr_spmm(row_of, col_of, values, b.cpu(), **kw)
    with pytest.raises(ValueError, match="multiple of the block side"):
        KB.bsr_spmm(row_of, col_of, values, b[:60], **kw)
    with pytest.raises(ValueError, match="row_start"):
        KB.bsr_spmm(row_of, col_of, values, b, n_block_rows=4,
                    row_start=rs.cpu())
    a = torch.zeros((8, 8), device=cuda)
    with pytest.raises(TypeError, match="bf16 is a later mode"):
        KD.dense_mm(a.bfloat16(), a.bfloat16())
    with pytest.raises(TypeError, match="bf16 is a later mode"):
        KD.dense_mm(a.double(), a)
    with pytest.raises(ValueError, match="contiguous"):
        KD.dense_mm(torch.zeros((8, 8), device=cuda).T, a)
    with pytest.raises(ValueError, match="contract"):
        KD.dense_mm(a, a[:5])


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["bsr", "dense"])
def test_engine_on_a_bound_plan_launches_one_kernel_per_wave(cuda, fmt):
    bsr, a = _bsr_operand(256, 384, 32, 32, 0.3, empty_rows=(2,))
    spec = sparse.SparseSpec(fmt, block=32 if fmt == "bsr" else None)
    bound = sparse.plan_for_operand(a, spec, device=cuda)
    eng = E.SpMMEngine(bound, max_wave_cols=256)
    assert eng.device.type == "cuda"
    rng = np.random.default_rng(3)
    widths = [128, 64, 32, 192, 128, 64, 600]      # the last one is split
    panels = [rng.normal(size=(384, w)).astype(np.float32) for w in widths]
    before = (KB.LAUNCHES["bsr_spmm"], KD.LAUNCHES["dense_mm"])
    for i, p in enumerate(panels):
        eng.submit(E.SpMMRequest(i, p))
    done = {r.rid: r for r in eng.run()}
    moved = (KB.LAUNCHES["bsr_spmm"] - before[0],
             KD.LAUNCHES["dense_mm"] - before[1])
    waves = eng.stats["waves"]
    assert waves > 0
    assert moved == ((waves, 0) if fmt == "bsr" else (0, waves))
    a64 = a.astype(np.float64)
    for i, p in enumerate(panels):
        want = a64 @ p.astype(np.float64)
        assert np.abs(done[i].out - want).max() <= \
            F64_TOL * np.abs(want).max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float64, np.float16],
                         ids=["float64", "float16"])
@pytest.mark.parametrize("fmt", ["bsr", "dense"])
def test_engine_on_a_bound_plan_serves_requests_that_are_not_f32(
        cuda, fmt, dtype):
    """The kernels take f32; the engine hands them the wave in f32 and
    each request gets its panel back in its own dtype, as the InCRS engine
    does."""
    _, a = _bsr_operand(128, 192, 32, 32, 0.4)
    spec = sparse.SparseSpec(fmt, block=32 if fmt == "bsr" else None)
    eng = E.SpMMEngine(sparse.plan_for_operand(a, spec, device=cuda),
                       max_wave_cols=256)
    rng = np.random.default_rng(4)
    panels = [rng.normal(size=(192, w)).astype(dtype) for w in (40, 24)]
    kname = "bsr_spmm" if fmt == "bsr" else "dense_mm"
    before = {**KB.LAUNCHES, **KD.LAUNCHES}[kname]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")         # f64: f32 precision, known
        for i, p in enumerate(panels):
            eng.submit(E.SpMMRequest(i, p))
        done = {r.rid: r for r in eng.run()}
    assert len(done) == 2
    waves = eng.stats["waves"]
    assert {**KB.LAUNCHES, **KD.LAUNCHES}[kname] - before == waves > 0
    a64 = a.astype(np.float64)
    for i, p in enumerate(panels):
        want = a64 @ p.astype(np.float64)
        tol = F64_TOL if dtype == np.float64 else 1e-3   # f16 rounding of C
        assert done[i].out.dtype == dtype
        assert np.abs(done[i].out.astype(np.float64) - want).max() <= \
            tol * np.abs(want).max()
