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
def test_engine_launches_one_kernel_per_wave(cuda, variant, monkeypatch,
                                             tmp_path):
    """One launch a wave: of the pinned order, or for ``auto`` of the
    order ``ops.resolve_incrs`` picks for that wave's width (the cost
    model's, the tuning cache being empty)."""
    from repro_torch.kernels import autotune
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "tune.json"))
    autotune.clear_memory_cache()
    picks = []
    resolve = ops.resolve_incrs

    def record(prep, n, **kw):
        got = resolve(prep, n, **kw)
        picks.append(dict(zip(("expand", "reuse", "pipelined"),
                              PORT))[got[0]])
        return got
    monkeypatch.setattr(ops, "resolve_incrs", record)
    dense = _dense("docword")
    inc = InCRS.from_dense(dense)
    rng = np.random.default_rng(1)
    widths = [128, 64, 32, 192, 128, 64, 600]      # the last one is split
    panels = [rng.normal(size=(dense.shape[1], w)).astype(np.float32)
              for w in widths]
    eng = E.SpMMEngine(inc, max_wave_cols=256, variant=variant, device=cuda)
    assert eng.prep.idx.device.type == "cuda"
    before = dict(K.LAUNCHES)
    picks.clear()
    for i, p in enumerate(panels):
        eng.submit(E.SpMMRequest(i, p))
    done = {r.rid: r for r in eng.run()}
    delta = {k: K.LAUNCHES[k] - before[k] for k in PORT}
    assert len(picks) == eng.stats["waves"] > 0
    assert delta == {k: picks.count(k) for k in PORT}
    if variant != "auto":
        ran = dict(zip(("expand", "reuse", "pipelined"), PORT))[variant]
        assert delta[ran] == eng.stats["waves"]
    assert eng.stats["split_requests"] == 1
    d64 = dense.astype(np.float64)
    for i, p in enumerate(panels):
        want = d64 @ p.astype(np.float64)
        assert done[i].out.shape == want.shape
        assert np.abs(done[i].out - want).max() <= \
            F64_TOL * np.abs(want).max()


def _random_stripes(m, n_sec, smax, section, seed, *, live=0.6,
                    heavy_rows=0, empty_section=None):
    """Stripes made directly: distinct random (unsorted) columns per row
    and section, pads between live slots. ``heavy_rows`` rows at the top
    keep every slot live and the others few (one row tile then holds most
    of the non-zeros); ``empty_section`` is all pads."""
    rng = np.random.default_rng(seed)
    idx = np.argsort(rng.random((m, n_sec, section)), axis=-1)[..., :smax]
    keep = rng.random(idx.shape) < live
    if heavy_rows:
        keep[:heavy_rows] = True
        keep[heavy_rows:] &= rng.random(keep[heavy_rows:].shape) < 0.1
    idx = np.where(keep, idx, -1).astype(np.int32)
    if empty_section is not None:
        idx[:, empty_section] = -1
    val = rng.normal(size=idx.shape).astype(np.float32)
    return idx, val


# (label, M, sections, smax, section, N): the skewed operand; M no multiple
# of the pipelined cluster's 64 rows; smax 1 and 33; an all-pad section;
# one section; N = 4, 36 and 640; sections over 256 rows (several TMA
# boxes per CTA at 512: 128 rows each of 4).
EDGE_STRIPES = [("skewed", 300, 6, 33, 256, 512),
                ("m_off_cluster", 77, 3, 20, 256, 128),
                ("smax_1", 90, 4, 1, 256, 64),
                ("smax_33", 130, 5, 33, 256, 36),
                ("all_pad_section", 70, 5, 12, 256, 128),
                ("one_section", 64, 1, 40, 256, 640),
                ("n_4", 50, 3, 9, 256, 4),
                ("n_36", 65, 2, 17, 256, 36),
                ("n_640", 40, 3, 33, 256, 640),
                ("section_300", 45, 3, 16, 300, 96),
                ("section_512", 33, 2, 24, 512, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", EDGE_STRIPES, ids=lambda c: c[0])
def test_three_orders_bitwise_on_edge_stripes(cuda, case):
    label, m, n_sec, smax, section, n = case
    idx, val = _random_stripes(
        m, n_sec, smax, section, seed=m + n,
        heavy_rows=24 if label == "skewed" else 0,
        empty_section=2 if label == "all_pad_section" else None)
    rng = np.random.default_rng(n)
    bt = torch.from_numpy(rng.normal(size=(n_sec * section, n)).astype(
        np.float32)).to(cuda)
    idx_t = torch.from_numpy(idx).to(cuda)
    val_t = torch.from_numpy(val).to(cuda)
    kw = dict(section=section, bm=8, bn=n)
    outs = [getattr(K, name)(idx_t, val_t, bt, **kw) for name in PORT]
    torch.cuda.synchronize()
    ref = K.plain("incrs_spmm", idx_t, val_t, bt, **kw)
    scale = max(float(ref.abs().max()), 1e-30)
    for out in outs:
        assert out.shape == (m, n)
        assert float((out - ref).abs().max()) <= KERNEL_TOL * scale
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.gpu
def test_skewed_operand_repeated(cuda):
    """A ring stage refilled while a slower CTA of the cluster still reads
    it gives wrong sums only now and then: the skewed operand (one row
    tile of four holds most non-zeros, so its CTA lags its cluster) run
    many times, every run bitwise equal to expand."""
    idx, val = _random_stripes(256, 24, 48, 256, seed=5, heavy_rows=40)
    bt = torch.from_numpy(np.random.default_rng(6).normal(
        size=(24 * 256, 512)).astype(np.float32)).to(cuda)
    idx_t = torch.from_numpy(idx).to(cuda)
    val_t = torch.from_numpy(val).to(cuda)
    kw = dict(section=256, bm=8, bn=512)
    want = K.incrs_spmm(idx_t, val_t, bt, **kw)
    for _ in range(20):
        assert torch.equal(K.incrs_spmm_pipelined(idx_t, val_t, bt, **kw),
                           want)


@pytest.mark.gpu
def test_a_cluster_the_card_cannot_place_raises(cuda):
    """Sixteen CTAs exceed the portable cluster size: the launcher refuses
    before any launch, the wrapper raises, and nothing is counted."""
    idx, val = _random_stripes(256, 2, 8, 256, seed=1)
    idx_t = torch.from_numpy(idx).to(cuda)
    val_t = torch.from_numpy(val).to(cuda)
    bt = torch.zeros(512, 64, device=cuda)
    good = K.pipelined_geometry(256, 64, 8, 256)
    bad = good._replace(cluster=16, row_tiles=32, box_rows=16)
    before = K.LAUNCHES["incrs_spmm_pipelined"]
    with pytest.raises(RuntimeError, match="CUDA error"):
        K._launch("incrs_spmm_pipelined", idx_t, val_t, bt, 256,
                  geometry=bad)
    assert K.LAUNCHES["incrs_spmm_pipelined"] == before
    out = K._launch("incrs_spmm_pipelined", idx_t, val_t, bt, 256,
                    geometry=good)
    assert torch.equal(out, K.incrs_spmm(idx_t, val_t, bt, section=256,
                                         bm=8, bn=64))


@pytest.mark.gpu
def test_gathering_orders_take_any_n_and_alignment(cuda):
    """N = 37 (expand's scalar loads), B a view 4 bytes off its
    allocation, and stripes 4 bytes off theirs (expand copies them to an
    aligned buffer before its 16-byte stripe copies): expand and reuse
    stay bitwise equal and within tolerance of the plain version."""
    m, n_sec, smax, section, n = 40, 3, 7, 256, 37   # no row padding
    idx, val = _random_stripes(m + 1, n_sec, smax, section, seed=3)
    idx_t = torch.from_numpy(idx).to(cuda)[1:]     # 84 bytes a row: off 16
    val_t = torch.from_numpy(val).to(cuda)[1:]
    assert idx_t.is_contiguous() and idx_t.data_ptr() % 16
    flat = torch.from_numpy(np.random.default_rng(4).normal(
        size=n_sec * section * n + 1).astype(np.float32)).to(cuda)
    bt = flat[1:].view(n_sec * section, n)
    kw = dict(section=section, bm=8, bn=n)
    expand = K.incrs_spmm(idx_t, val_t, bt, **kw)
    reuse = K.incrs_spmm_reuse(idx_t, val_t, bt, **kw)
    torch.cuda.synchronize()
    assert torch.equal(expand, reuse)
    ref = K.plain("incrs_spmm", idx_t, val_t, bt, **kw)
    assert float((expand - ref).abs().max()) <= \
        KERNEL_TOL * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,off,window,cap", [(128, 256, None, None),
                                               (77, 301, None, None),
                                               (200, 512, 128, None),
                                               (130, 2048, 2048, 30.0)])
def test_flash_query_offset(cuda, dtype, sq, off, window, cap):
    """The flash kernels at a query offset (rows at ``q_offset``.., keys
    0..Sq + q_offset: a sequence-parallel span) against the plain version
    on the same inputs, the f32 kernel within 1e-5 of max|out|, the bf16
    kernel row by row within 1e-2 (``worst_row_error``); and the span equal
    to the same rows of the whole sequence's launch, bitwise."""
    from repro_torch.kernels import flash_attention as F
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(sq + off)
    sk, kv, g, hd = sq + off, 2, 4, 64
    q = torch.randn((1, sk, kv, g, hd), generator=gen).to(cuda, dt)
    k = torch.randn((1, sk, kv, hd), generator=gen).to(cuda, dt)
    v = torch.randn((1, sk, kv, hd), generator=gen).to(cuda, dt)
    span = q[:, off:].contiguous()
    with torch.no_grad():
        got = F.flash_attention(span, k, v, window=window, soft_cap=cap,
                                q_offset=off)
        whole = F.flash_attention(q, k, v, window=window, soft_cap=cap)
    want = F.plain(span.float().cpu(), k.float().cpu(), v.float().cpu(),
                   window=window, soft_cap=cap, q_offset=off)
    if dtype == "float32":
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        assert err <= 1e-5, err
    else:
        assert F.worst_row_error(got.cpu(), want) <= 1e-2
    assert torch.equal(got, whole[:, off:])
