"""The port's BSR and dense kernels on the card: each against its plain
torch version and the float64 product on edge operands, the wrappers'
refusals, and bsr / dense plans served one kernel launch per wave.

This file imports nothing of JAX, so it runs on a machine that has the card
and no JAX: ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_cuda_plan.py`` (the shared conftest imports JAX). On a
machine without CUDA every test skips.

Tolerances: kernel against plain version ``1e-5 * max|C|`` (the plain
versions sum in another order); against the float64 product
``1e-4 * max|C|`` (f32 accumulation). bf16 operands (the tensor-core
instance, or the general kernel for other shapes) are held row by row
against the plain version on the same bf16 inputs: ``1e-2`` of each row's
max|C| (``flash_attention.worst_row_error``; C is rounded to bf16).
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
from repro_torch.kernels.flash_attention import worst_row_error  # noqa: E402
from repro_torch.serve import engine as E                 # noqa: E402

KERNEL_TOL = 1e-5
F64_TOL = 1e-4
BF16_TOL = 1e-2


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
    with pytest.raises(TypeError, match="f32 or bf16"):
        KB.bsr_spmm(row_of, col_of, values.double(), b, **kw)
    with pytest.raises(TypeError, match="f32 or bf16"):
        KB.bsr_spmm(row_of, col_of, values.half(), b.half(), **kw)
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
    with pytest.raises(TypeError, match="f32 or bf16"):
        KD.dense_mm(a.half(), a.half())
    with pytest.raises(TypeError, match="f32 or bf16"):
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
    """The kernels take f32 or bf16: the wrapper promotes an f16 wave with
    the plan's f32 values, the engine narrows an f64 wave to f32 (the
    kernels sum in f32), and each request gets its panel back in its own
    dtype, as the InCRS engine does."""
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


def _instance_ran(mod, before, want):
    moved = {k: v - before[k] for k, v in mod.INSTANCE_LAUNCHES.items()
             if v != before[k]}
    assert moved == {want: 1}, moved


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(256, 512, 384), (127, 136, 264),
                                   (700, 2048, 512), (127, 129, 300),
                                   (1, 1, 1), (33, 1000, 5)],
                         ids=lambda s: "x".join(map(str, s)))
def test_dense_kernel_bf16_matches_plain_row_by_row(cuda, shape):
    """bf16 A and B: the wgmma instance where K and N are multiples of 8,
    the general kernel elsewhere; C in bf16."""
    m, k, n = shape
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    b = torch.randn(k, n, generator=g, device=cuda).bfloat16()
    want = KD.gemm_geometry(m, n, k, torch.bfloat16).instance
    assert want == ("bf16_wgmma" if k % 8 == 0 and n % 8 == 0
                    else "general_bf16")
    before = dict(KD.INSTANCE_LAUNCHES)
    out = KD.dense_mm(a, b)
    torch.cuda.synchronize()
    _instance_ran(KD, before, want)
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    assert worst_row_error(out, KD.plain(a, b)) <= BF16_TOL
    assert torch.equal(out, KD.dense_mm(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("case", BSR_CASES + [
    ("block64_bf16_fast", 640, 768, 64, 64, 0.4, (0, 3), 512)],
    ids=lambda c: c[0])
def test_bsr_kernel_bf16_matches_plain_row_by_row(cuda, case):
    """bf16 values and B: the wgmma instance for bm a multiple of 64 and
    bk of 64, the general kernel for the other blocks; C in bf16."""
    label, m, k, bm, bk, density, empty, n = case
    bsr, _ = _bsr_operand(m, k, bm, bk, density, empty)
    row_of, col_of, values, rs = ops.prep_bsr(bsr, device=cuda)
    values = values.bfloat16()
    b = torch.from_numpy(np.random.default_rng(1).normal(
        size=(k, n)).astype(np.float32)).to(cuda).bfloat16()
    nbr = bsr.n_block_rows
    want = KB.gemm_geometry(nbr, bm, bk, n, torch.bfloat16,
                            nnz=values.shape[0]).instance
    assert want == ("bf16_wgmma" if bm % 64 == 0 and bk % 64 == 0 and
                    n % 8 == 0 else "general_bf16")
    before = dict(KB.INSTANCE_LAUNCHES)
    out = KB.bsr_spmm(row_of, col_of, values, b, n_block_rows=nbr,
                      row_start=rs)
    torch.cuda.synchronize()
    _instance_ran(KB, before, want)
    ref = KB.plain(row_of, col_of, values, b, n_block_rows=nbr)
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    assert worst_row_error(out, ref) <= BF16_TOL
    if density == 0.0:
        assert not bool(out.any())


@pytest.mark.gpu
def test_mixed_types_promote_and_keep_the_contract_dtype(cuda):
    """bf16 A with f32 B runs the f32 instance and gives ``a.dtype``
    (dense) or ``b.dtype`` (BSR), as the plain versions and JAX do."""
    g = torch.Generator(device=cuda).manual_seed(6)
    a = torch.randn(256, 512, generator=g, device=cuda)
    b = torch.randn(512, 128, generator=g, device=cuda)
    before = dict(KD.INSTANCE_LAUNCHES)
    out = KD.dense_mm(a.bfloat16(), b)
    torch.cuda.synchronize()
    _instance_ran(KD, before, "f32_fma")
    assert out.dtype == torch.bfloat16
    ref = KD.plain(a.bfloat16(), b)
    assert ref.dtype == torch.bfloat16 and torch.equal(
        out, KD.dense_mm(a.bfloat16(), b))
    assert worst_row_error(out, ref) <= BF16_TOL
    out = KD.dense_mm(a, b.bfloat16())
    assert out.dtype == torch.float32
    assert float((out - KD.plain(a, b.bfloat16())).abs().max()) <= \
        KERNEL_TOL * float(out.abs().max())
    bsr, _ = _bsr_operand(256, 512, 128, 128, 0.5)
    row_of, col_of, values, rs = ops.prep_bsr(bsr, device=cuda)
    kw = dict(n_block_rows=bsr.n_block_rows, row_start=rs)
    before = dict(KB.INSTANCE_LAUNCHES)
    out = KB.bsr_spmm(row_of, col_of, values.bfloat16(), b, **kw)
    torch.cuda.synchronize()
    _instance_ran(KB, before, "f32_fma")
    assert out.dtype == torch.float32
    ref = KB.plain(row_of, col_of, values.bfloat16(), b,
                   n_block_rows=bsr.n_block_rows)
    assert float((out - ref).abs().max()) <= \
        KERNEL_TOL * float(ref.abs().max())
    out = KB.bsr_spmm(row_of, col_of, values, b.bfloat16(), **kw)
    assert out.dtype == torch.bfloat16


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_split_k_is_deterministic_at_a_docword_shape(cuda, dtype):
    """docword's dense operand (700 x 12000) at N = 512: 24 tiles, split
    over K so that the card fills; the last CTA of each tile adds the
    partials in split order, so two launches give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(7)
    a = torch.randn(700, 12000, generator=g, device=cuda).to(dtype)
    b = torch.randn(12000, 512, generator=g, device=cuda).to(dtype)
    geo = KD.gemm_geometry(700, 512, 12000, dtype)
    assert geo.splits > 1
    outs = [KD.dense_mm(a, b) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    ref = KD.plain(a, b)
    if dtype == torch.float32:
        assert float((outs[0] - ref).abs().max()) <= \
            KERNEL_TOL * float(ref.abs().max())
        one = KD._launch(a, b, geometry=KD.gemm_geometry(
            700, 512, 12000, dtype, splits=1))
        assert float((one - outs[0]).abs().max()) <= \
            KERNEL_TOL * float(ref.abs().max())
    else:
        assert worst_row_error(outs[0], ref) <= BF16_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_bsr_skewed_block_rows(cuda, dtype):
    """Block-rows of 0 to 32 stored 128 x 128 blocks (and split-K over the
    short operand): every row against the plain version, repeated launches
    bitwise equal."""
    rng = np.random.default_rng(8)
    nbr, nbc, blk = 8, 32, 128
    keep = np.zeros((nbr, nbc), bool)
    for r, count in enumerate((1, 2, 4, 8, 16, 32, 0, 3)):
        keep[r, rng.choice(nbc, size=count, replace=False)] = True
    a = rng.uniform(-1.5, 1.5, size=(nbr * blk, nbc * blk)).astype(
        np.float32)
    a = (a.reshape(nbr, blk, nbc, blk) * keep[:, None, :, None]).reshape(
        nbr * blk, nbc * blk)
    bsr = BSR.from_mask(a, keep, (blk, blk))
    row_of, col_of, values, rs = ops.prep_bsr(bsr, device=cuda)
    values = values.to(dtype)
    b = torch.from_numpy(rng.normal(size=(nbc * blk, 256)).astype(
        np.float32)).to(cuda).to(dtype)
    geo = KB.gemm_geometry(nbr, blk, blk, 256, dtype, nnz=values.shape[0])
    assert geo.splits > 1
    outs = [KB.bsr_spmm(row_of, col_of, values, b, n_block_rows=nbr,
                        row_start=rs) for _ in range(5)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    ref = KB.plain(row_of, col_of, values, b, n_block_rows=nbr)
    assert not bool(outs[0][6 * blk:7 * blk].any())      # the empty row
    if dtype == torch.float32:
        assert float((outs[0] - ref).abs().max()) <= \
            KERNEL_TOL * float(ref.abs().max())
    else:
        assert worst_row_error(outs[0], ref) <= BF16_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["bsr", "dense"])
def test_engine_serves_a_bf16_plan_with_bf16_requests(cuda, fmt):
    """A bf16 plan (``Linear.from_dense(..., dtype=bfloat16)``) served with
    bf16 requests (CPU tensors): one bf16-instance launch per wave, each
    panel back as a bf16 tensor."""
    _, a = _bsr_operand(256, 384, 128, 128, 0.5)
    spec = sparse.SparseSpec(fmt, block=128 if fmt == "bsr" else None)
    lin = sparse.Linear.from_dense(np.ascontiguousarray(a.T), spec,
                                   dtype=torch.bfloat16, device=cuda)
    eng = E.SpMMEngine(lin.bound(), max_wave_cols=256)
    rng = np.random.default_rng(9)
    panels = [torch.from_numpy(rng.normal(size=(384, w)).astype(
        np.float32)).bfloat16() for w in (128, 64, 200, 300)]
    mod = KB if fmt == "bsr" else KD
    before = dict(mod.INSTANCE_LAUNCHES)
    for i, p in enumerate(panels):
        eng.submit(E.SpMMRequest(i, p))
    done = {r.rid: r for r in eng.run()}
    assert {k: v - before[k] for k, v in mod.INSTANCE_LAUNCHES.items()
            if v != before[k]} == {"bf16_wgmma": eng.stats["waves"]}
    a16 = torch.from_numpy(lin.to_dense().T.copy()).double()
    for i, p in enumerate(panels):
        out = done[i].out
        assert isinstance(out, torch.Tensor) and out.dtype == torch.bfloat16
        assert worst_row_error(out, a16 @ p.double()) <= BF16_TOL
