"""The port's CUDA kernels on the card: each against its plain torch version
and the float64 product, the three bitwise against each other, and the
serving engine launching one kernel per wave.

This file imports nothing of JAX, so it runs on a machine that has the card
and no JAX: ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_cuda_kernels.py`` (the shared conftest imports JAX). On a
machine without CUDA every test skips.

Tolerances: kernel against plain version ``1e-5 * max|C|`` (the plain
version sums the expanded slab in another order); against the float64
product ``1e-4 * max|C|`` (f32 accumulation).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.incrs import InCRS                  # noqa: E402
from repro_torch.data import datasets                     # noqa: E402
from repro_torch.kernels import incrs_spmm as K           # noqa: E402
from repro_torch.kernels import ops                       # noqa: E402
from repro_torch.serve import engine as E                 # noqa: E402

PORT = ("incrs_spmm", "incrs_spmm_reuse", "incrs_spmm_pipelined")
KERNEL_TOL = 1e-5
F64_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _dense(name):
    rng = np.random.default_rng(3)

    def sparse(m, k, d):
        a = rng.uniform(0.5, 1.5, size=(m, k)).astype(np.float32)
        a[rng.random(size=(m, k)) >= d] = 0.0
        return a

    if name == "docword":
        spec = datasets.scaled(datasets.TABLE2_DATASETS["docword"], 0.06)
        return datasets.synthesize(spec, 0).to_dense()
    if name == "m_ragged":                      # M not a multiple of 8
        return sparse(29, 600, 0.05)
    if name == "empty_rows":
        a = sparse(24, 700, 0.05)
        a[3] = 0.0
        a[10:14] = 0.0
        return a
    if name == "smax_1":
        a = np.zeros((16, 768), np.float32)
        for r in range(16):
            for s in range(0, 3, 1 + r % 2):
                a[r, s * 256 + rng.integers(256)] = 1.0 + r
        return a
    if name == "dense_section":
        a = sparse(12, 600, 0.03)
        a[:, 256:512] = rng.uniform(0.5, 1.5, size=(12, 256))
        return a
    if name == "k_ragged":                      # K not a multiple of S
        return sparse(20, 300, 0.1)
    raise ValueError(name)


# (operand, bm, bn, n); n = 160 leaves a partial 32-column pipelined tile.
CASES = [("docword", 16, 128, 256), ("docword", 128, 256, 256),
         ("m_ragged", 8, 64, 64), ("empty_rows", 8, 160, 160),
         ("smax_1", 128, 128, 128), ("dense_section", 8, 128, 128),
         ("k_ragged", 16, 32, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernels_match_plain_and_each_other(cuda, case):
    name, bm, bn, n = case
    dense = _dense(name)
    prep = ops.prepare_incrs(InCRS.from_dense(dense), pad_rows_to=1,
                             device=cuda)
    kp = prep.n_sections * prep.section
    b = np.zeros((kp, n), np.float32)
    b[:dense.shape[1]] = np.random.default_rng(9).normal(
        size=(dense.shape[1], n))
    bt = torch.from_numpy(b).to(cuda)
    want = dense.astype(np.float64) @ b[:dense.shape[1]].astype(np.float64)
    outs = []
    for kname in PORT:
        before = K.LAUNCHES[kname]
        out = getattr(K, kname)(prep.idx, prep.val, bt, section=prep.section,
                                bm=bm, bn=bn)
        torch.cuda.synchronize()
        assert K.LAUNCHES[kname] == before + 1
        ref = K.plain(kname, prep.idx, prep.val, bt, section=prep.section,
                      bm=bm, bn=bn)
        scale = max(float(ref.abs().max()), 1e-30)
        assert float((out - ref).abs().max()) <= KERNEL_TOL * scale
        got = out.cpu().numpy()[:dense.shape[0]]
        assert np.abs(got - want).max() <= F64_TOL * max(np.abs(want).max(),
                                                         1e-30)
        outs.append(out)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    idx = torch.full((8, 1, 2), -1, dtype=torch.int32, device=cuda)
    val = torch.zeros((8, 1, 2), device=cuda)
    b = torch.zeros((256, 8), device=cuda)
    with pytest.raises(TypeError):
        K.incrs_spmm(idx.long(), val, b, bn=8)
    with pytest.raises(ValueError, match="contiguous"):
        K.incrs_spmm(idx, val, torch.zeros((8, 256), device=cuda).T, bn=8)
    # a stripe too deep for the reuse order's staging buffers (N no longer
    # matters: test_reuse_takes_wide_n)
    deep = torch.full((8, 1, 1000), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        K.incrs_spmm_reuse(deep, torch.zeros((8, 1, 1000), device=cuda), b,
                           bn=8)
    with pytest.raises(ValueError, match="share one device"):
        K.incrs_spmm(idx, val, b.cpu(), bn=8)
    with pytest.raises(ValueError, match="multiple of 4"):
        K.incrs_spmm_pipelined(idx, val, torch.zeros((256, 6), device=cuda),
                               bn=6)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.incrs_spmm_pipelined(idx, val, torch.zeros(256 * 8 + 1,
                                                     device=cuda)[1:]
                               .view(256, 8), bn=8)


def _stripes(cuda, name):
    dense = _dense(name)
    prep = ops.prepare_incrs(InCRS.from_dense(dense), pad_rows_to=1,
                             device=cuda)
    return dense, prep


def _rhs(cuda, dense, prep, n, seed=9):
    b = np.zeros((prep.n_sections * prep.section, n), np.float32)
    b[:dense.shape[1]] = np.random.default_rng(seed).normal(
        size=(dense.shape[1], n))
    return torch.from_numpy(b).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["m_ragged", "empty_rows"])
@pytest.mark.parametrize("n", [8, 160, 384, 512, 640, 1200])
def test_reuse_bitwise_equal_to_expand_and_pipelined(cuda, name, n):
    """Every panel width of the reuse order (128, 256, 512 columns, and
    several 512-column panels) at a row count that is no multiple of its
    row tile."""
    dense, prep = _stripes(cuda, name)
    bt = _rhs(cuda, dense, prep, n)
    kw = dict(section=prep.section, bm=8, bn=n)
    reuse = K.incrs_spmm_reuse(prep.idx, prep.val, bt, **kw)
    expand = K.incrs_spmm(prep.idx, prep.val, bt, **kw)
    piped = K.incrs_spmm_pipelined(prep.idx, prep.val, bt, **kw)
    torch.cuda.synchronize()
    assert torch.equal(reuse, expand) and torch.equal(reuse, piped)
    ref = K.plain("incrs_spmm_reuse", prep.idx, prep.val, bt, **kw)
    assert float((reuse - ref).abs().max()) <= \
        KERNEL_TOL * float(ref.abs().max())


@pytest.mark.gpu
def test_reuse_takes_wide_n(cuda):
    """N = 65,536: 128 panels of 512 columns, no panel in shared memory."""
    dense, prep = _stripes(cuda, "k_ragged")
    bt = _rhs(cuda, dense, prep, 65536)
    kw = dict(section=prep.section, bm=8, bn=65536)
    out = K.incrs_spmm_reuse(prep.idx, prep.val, bt, **kw)
    ref = K.plain("incrs_spmm_reuse", prep.idx, prep.val, bt, **kw)
    assert float((out - ref).abs().max()) <= \
        KERNEL_TOL * float(ref.abs().max())
    assert torch.equal(out, K.incrs_spmm(prep.idx, prep.val, bt, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8, 160, 512])
def test_reuse_at_the_deepest_stripe_the_wrapper_takes(cuda, n):
    """The wrapper sizes the reuse kernel's shared memory: at the deepest
    stripe it takes for N, every live slot still lands inside it."""
    smax = 1
    while K.reuse_smem_bytes(n, smax + 1) <= K.SMEM_LIMIT:
        smax += 1
    with pytest.raises(ValueError, match="shared memory"):
        K.launch_geometry("incrs_spmm_reuse", n, smax + 1, 4096)
    rng = np.random.default_rng(n)
    m, section = 37, 4096
    idx = np.stack([np.sort(rng.choice(section, smax, replace=False))
                    for _ in range(m)])[:, None].astype(np.int32)
    idx[rng.random(idx.shape) < 0.3] = -1        # pad slots between live
    val = rng.normal(size=idx.shape).astype(np.float32)
    bt = torch.from_numpy(rng.normal(size=(section, n)).astype(
        np.float32)).to(cuda)
    idx_t, val_t = torch.from_numpy(idx).to(cuda), torch.from_numpy(
        val).to(cuda)
    kw = dict(section=section, bm=8, bn=n)
    reuse = K.incrs_spmm_reuse(idx_t, val_t, bt, **kw)
    assert torch.equal(reuse, K.incrs_spmm(idx_t, val_t, bt, **kw))
    ref = K.plain("incrs_spmm_reuse", idx_t, val_t, bt, **kw)
    assert float((reuse - ref).abs().max()) <= \
        KERNEL_TOL * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["auto", "expand", "reuse", "pipelined"])
def test_engine_launches_one_kernel_per_wave(cuda, variant):
    dense = _dense("docword")
    inc = InCRS.from_dense(dense)
    rng = np.random.default_rng(1)
    widths = [128, 64, 32, 192, 128, 64, 600]      # the last one is split
    panels = [rng.normal(size=(dense.shape[1], w)).astype(np.float32)
              for w in widths]
    eng = E.SpMMEngine(inc, max_wave_cols=256, variant=variant, device=cuda)
    assert eng.prep.idx.device.type == "cuda"
    ran = "incrs_spmm" if variant == "auto" else \
        dict(zip(("expand", "reuse", "pipelined"), PORT))[variant]
    before = dict(K.LAUNCHES)
    for i, p in enumerate(panels):
        eng.submit(E.SpMMRequest(i, p))
    done = {r.rid: r for r in eng.run()}
    delta = {k: K.LAUNCHES[k] - before[k] for k in PORT}
    assert delta[ran] == eng.stats["waves"] > 0
    assert sum(delta.values()) == delta[ran]
    assert eng.stats["split_requests"] == 1
    d64 = dense.astype(np.float64)
    for i, p in enumerate(panels):
        want = d64 @ p.astype(np.float64)
        assert done[i].out.shape == want.shape
        assert np.abs(done[i].out - want).max() <= \
            F64_TOL * np.abs(want).max()
