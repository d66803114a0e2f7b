"""The port's sparse × sparse kernels on the card: index matching, condense,
merge and the InCRS gather, each against its plain torch version and the
float64 product; condense + merge bitwise equal to index matching; the
engines of ``ops.spmm(CRS, CRS)`` launching what each implies.

This file imports nothing of JAX, so it runs on a machine that has the card
and no JAX: ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_cuda_spgemm.py`` (the shared conftest imports JAX). On a
machine without CUDA every test skips.

Both instances of index matching and condense (``match_geometry``: the
ring and the general kernel) are held to each other, to their repeats and
to condense + merge bit for bit, on pads in any slot, an index repeated
in a round window, empty tiles, wide windows and ring geometries off the
rule.

The gather's tile instance and merge's ring are held to their first
designs (``gather_geometry``, ``merge_geometry`` overrides) and to the
CPU's plain versions, an index repeated in a stripe, widths that are not
a multiple of 4 and views 4 bytes off 16 included.

Tolerances: index matching and condense against their plain versions
``1e-5 * max|C|`` (the plain version multiplies dense round windows, in
another order); against the float64 product ``1e-4 * max|C|`` (f32
accumulation). Merge, condense + merge against index matching, and the
gather against its plain version: bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spgemm                            # noqa: E402
from repro_torch.core.crs import CRS                      # noqa: E402
from repro_torch.core.incrs import InCRS                  # noqa: E402
from repro_torch.data import datasets                     # noqa: E402
from repro_torch.kernels import incrs_gather as G         # noqa: E402
from repro_torch.kernels import incrs_spmm as K1          # noqa: E402
from repro_torch.kernels import index_match_spmm as IM    # noqa: E402
from repro_torch.kernels import ops                       # noqa: E402
from repro_torch.spgemm import kernels as SK              # noqa: E402

KERNEL_TOL = 1e-5
F64_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions in f32
    return torch.device("cuda")


def _sparse(rng, m, k, d):
    a = rng.uniform(-1.5, 1.5, size=(m, k)).astype(np.float32)
    a[rng.random(size=(m, k)) >= d] = 0.0
    return a


def _pair(name, rounds):
    """(A, Bt) dense f32: C = A @ Bt.T."""
    rng = np.random.default_rng(5)
    if name == "docword4":
        spec = datasets.scaled(datasets.TABLE4_DATASETS["docword4"], 0.1)
        a = datasets.synthesize(spec, 0).to_dense()
        return a, a
    if name == "zero":
        return np.zeros((40, 300), np.float32), _sparse(rng, 24, 300, 0.1)
    if name == "empty_rows":
        a = _sparse(rng, 64, 500, 0.05)
        a[3] = 0.0
        a[10:20] = 0.0
        return a, a
    if name == "rmax_1":                   # one non-zero per live window
        a = np.zeros((48, 4 * rounds), np.float32)
        for r in range(48):
            for t in range(0, 4, 1 + r % 2):
                a[r, t * rounds + rng.integers(rounds)] = 1.0 + r
        return a, a
    if name == "full_window":              # a round window of R non-zeros
        a = _sparse(rng, 40, 3 * rounds, 0.05)
        a[::3, rounds:2 * rounds] = rng.uniform(0.5, 1.5,
                                                size=(14, rounds))
        return a, a
    if name == "ragged":                   # K % R, M % bm, N % bn != 0
        return _sparse(rng, 203, 333, 0.08), _sparse(rng, 77, 333, 0.1)
    raise ValueError(name)


CASES = ["docword4", "zero", "empty_rows", "rmax_1", "full_window", "ragged"]


def _prep(dense, rounds, pad, dev):
    return ops.prep_rounds(CRS.from_dense(dense), rounds, pad_rows_to=pad,
                           device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("rounds", [32, 128])
@pytest.mark.parametrize("name", CASES)
def test_match_kernels_against_plain_and_each_other(cuda, name, rounds):
    a, bt = _pair(name, rounds)
    ai, av = _prep(a, rounds, 64, cuda)
    bi, bv = _prep(bt, rounds, 32, cuda)
    ai, av, bi, bv = ops.pad_common_rmax(ai, av, bi, bv)
    if name == "rmax_1":
        assert ai.shape[2] == 1
    if name == "full_window":
        assert ai.shape[2] == rounds
    kw = dict(rounds=rounds, bm=64, bn=32)
    before = dict(IM.LAUNCHES, **SK.LAUNCHES)
    fused = IM.index_match_spmm(ai, av, bi, bv, **kw)
    stripes = SK.spgemm_condense(ai, av, bi, bv, **kw)
    merged = SK.spgemm_merge(stripes, bm=64, bn=32)
    torch.cuda.synchronize()
    assert IM.LAUNCHES["index_match_spmm"] == \
        before["index_match_spmm"] + 1
    for k in SK.LAUNCHES:
        assert SK.LAUNCHES[k] == before[k] + 1
    assert fused.dtype == merged.dtype == torch.float32
    assert torch.equal(merged, fused)
    ref = IM.plain(ai, av, bi, bv, **kw)
    scale = max(float(ref.abs().max()), 1e-30)
    assert float((fused - ref).abs().max()) <= KERNEL_TOL * scale
    plain_s = SK.plain_condense(ai, av, bi, bv, **kw)
    assert float((stripes - plain_s).abs().max()) <= KERNEL_TOL * scale
    assert torch.equal(SK.plain_merge(stripes, bm=64, bn=32), merged)
    want = a.astype(np.float64) @ bt.astype(np.float64).T
    got = fused.cpu().numpy()[:a.shape[0], :bt.shape[0]]
    assert np.abs(got - want).max() <= F64_TOL * max(np.abs(want).max(),
                                                     1e-30)
    if name == "zero":
        assert not fused.any()


def _shuffle_slots(idx, val, seed):
    """The same operand with each (row, round)'s slots in a random order:
    pads between and before live slots."""
    rng = np.random.default_rng(seed)
    perm = torch.from_numpy(np.argsort(rng.random(tuple(idx.shape)),
                                       axis=2)).to(idx.device)
    return (idx.gather(2, perm).contiguous(),
            val.gather(2, perm).contiguous())


def _instance_pair(name, rounds):
    """(A, Bt) dense f32 for the instance tests: the CASES, plus empty
    tiles (rounds whose windows are empty across whole 128-row tiles on
    one side), a window of 40 non-zeros (rmax > 32, not R), and a tall A
    that takes several tiles a CTA."""
    rng = np.random.default_rng(11)
    if name == "empty_tiles":
        a = _sparse(rng, 600, 4 * rounds, 0.05)
        a[100:, rounds:2 * rounds] = 0.0       # round 1: rows >= 100 empty
        a[:, 3 * rounds:] = 0.0                # round 3: empty everywhere
        bt = _sparse(rng, 300, 4 * rounds, 0.05)
        bt[:, 2 * rounds:3 * rounds] = 0.0     # round 2: B empty
        return a, bt
    if name == "rmax_40":
        a = _sparse(rng, 90, 3 * rounds, 0.04)
        for r in range(0, 90, 7):
            a[r, rounds + rng.choice(rounds, min(40, rounds - 4),
                                     replace=False)] = 1.0 + r
        return a, a
    if name == "tall":
        return _sparse(rng, 1100, 2 * rounds, 0.03), \
            _sparse(rng, 260, 2 * rounds, 0.05)
    return _pair(name, rounds)


INSTANCE_CASES = CASES + ["interleaved", "repeats", "empty_tiles", "rmax_40",
                          "tall"]


def _repeat_slots(idx, val):
    """Every 5th row repeats its first slot of each round in its last
    (padded) slot: an index twice in one round window, which the one-hot
    form sums."""
    idx, val = idx.clone(), val.clone()
    rows = torch.arange(0, idx.shape[0], 5, device=idx.device)
    free = (idx[rows, :, 0] >= 0) & (idx[rows, :, -1] < 0)
    last_i, last_v = idx[rows, :, -1], val[rows, :, -1]
    idx[rows, :, -1] = torch.where(free, idx[rows, :, 0], last_i)
    val[rows, :, -1] = torch.where(free, val[rows, :, 0] * 0.5, last_v)
    return idx, val


def _match_geo(kernel, ai, bi, rounds, **kw):
    m, n_rounds, ra = ai.shape
    return IM.match_geometry(m, bi.shape[0], n_rounds, ra, bi.shape[2],
                             rounds, kernel, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("rounds", [32, 128])
@pytest.mark.parametrize("name", INSTANCE_CASES)
def test_instances_bitwise_equal_and_repeatable(cuda, name, rounds):
    """Each instance of index matching against its repeat, its condense +
    merge and the other instance, bit for bit; against its plain version
    within KERNEL_TOL. Pads may sit anywhere in the slot axis."""
    a, bt = _instance_pair("docword4" if name in ("interleaved", "repeats")
                           else name, rounds)
    ai, av = _prep(a, rounds, 64, cuda)
    bi, bv = _prep(bt, rounds, 32, cuda)
    ai, av, bi, bv = ops.pad_common_rmax(ai, av, bi, bv)
    if name == "interleaved":
        ai, av = _shuffle_slots(ai, av, 1)
        bi, bv = _shuffle_slots(bi, bv, 2)
        assert bool(((ai[..., :-1] < 0) & (ai[..., 1:] >= 0)).any())
    if name == "repeats":
        ai, av = _repeat_slots(ai, av)
        bi, bv = _repeat_slots(bi, bv)
        assert bool((bi[..., -1] >= 0).any())
    if name == "rmax_40" and rounds == 128:
        assert 32 < ai.shape[2] < rounds
    kw = dict(rounds=rounds, bm=64, bn=32)
    ref = IM.plain(ai, av, bi, bv, **kw)
    scale = max(float(ref.abs().max()), 1e-30)
    fused = {}
    for inst in IM.INSTANCES:
        gf = _match_geo("index_match_spmm", ai, bi, rounds, instance=inst)
        gc = _match_geo("spgemm_condense", ai, bi, rounds, instance=inst)
        assert (gf.instance, gc.instance) == (inst, inst)
        before = dict(IM.INSTANCE_LAUNCHES)
        out = IM.index_match_spmm(ai, av, bi, bv, geometry=gf, **kw)
        again = IM.index_match_spmm(ai, av, bi, bv, geometry=gf, **kw)
        stripes = SK.spgemm_condense(ai, av, bi, bv, geometry=gc, **kw)
        stripes2 = SK.spgemm_condense(ai, av, bi, bv, geometry=gc, **kw)
        merged = SK.spgemm_merge(stripes, bm=64, bn=32)
        torch.cuda.synchronize()
        assert IM.INSTANCE_LAUNCHES[f"index_match_spmm/{inst}"] == \
            before[f"index_match_spmm/{inst}"] + 2
        assert IM.INSTANCE_LAUNCHES[f"spgemm_condense/{inst}"] == \
            before[f"spgemm_condense/{inst}"] + 2
        assert torch.equal(out, again) and torch.equal(stripes, stripes2)
        assert torch.equal(merged, out)
        assert float((out - ref).abs().max()) <= KERNEL_TOL * scale
        for t in range(stripes.shape[0]):
            part = IM.round_partial(ai, av, bi, bv, t, rounds)
            assert float((stripes[t] - part).abs().max()) <= \
                KERNEL_TOL * scale
        fused[inst] = out
    assert torch.equal(fused["ring"], fused["general"])
    if name == "zero":
        assert not fused["ring"].any()


# Ring geometries off the rule: rows per warp, ring depth, condense's
# items per CTA (1: a CTA an item; 7: chunks that cut tiles' rounds).
RING_SWEEP = [dict(rows_per_warp=1), dict(rows_per_warp=16),
              dict(stages=4), dict(stages=8), dict(chunk=1), dict(chunk=7)]


@pytest.mark.gpu
@pytest.mark.parametrize("over", RING_SWEEP,
                         ids=lambda d: "-".join(f"{k}{v}" for k, v in
                                                d.items()))
def test_ring_geometries_agree_with_the_general_instance(cuda, over):
    a, bt = _instance_pair("tall", 128)
    ai, av = _prep(a, 128, 64, cuda)
    bi, bv = _prep(bt, 128, 32, cuda)
    ai, av, bi, bv = ops.pad_common_rmax(ai, av, bi, bv)
    kw = dict(rounds=128, bm=64, bn=32)
    want = IM.index_match_spmm(
        ai, av, bi, bv, geometry=_match_geo("index_match_spmm", ai, bi, 128,
                                            instance="general"), **kw)
    fk = {k: v for k, v in over.items() if k != "chunk"}
    out = IM.index_match_spmm(
        ai, av, bi, bv, geometry=_match_geo("index_match_spmm", ai, bi, 128,
                                            instance="ring", **fk), **kw)
    stripes = SK.spgemm_condense(
        ai, av, bi, bv, geometry=_match_geo("spgemm_condense", ai, bi, 128,
                                            instance="ring", **over), **kw)
    merged = SK.spgemm_merge(stripes, bm=64, bn=32)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(merged, want)


@pytest.mark.gpu
def test_a_window_too_wide_for_the_ring_runs_the_general_instance(cuda):
    a, bt = _pair("ragged", 256)
    ai, av = _prep(a, 256, 64, cuda)
    bi, bv = _prep(bt, 256, 32, cuda)
    ai, av, bi, bv = ops.pad_common_rmax(ai, av, bi, bv)
    kw = dict(rounds=256, bm=64, bn=32)
    assert _match_geo("index_match_spmm", ai, bi, 256).instance == "general"
    before = IM.INSTANCE_LAUNCHES["index_match_spmm/general"]
    out = IM.index_match_spmm(ai, av, bi, bv, **kw)
    torch.cuda.synchronize()
    assert IM.INSTANCE_LAUNCHES["index_match_spmm/general"] == before + 1
    ref = IM.plain(ai, av, bi, bv, **kw)
    assert float((out - ref).abs().max()) <= \
        KERNEL_TOL * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["docword4", "empty_rows", "ragged"])
def test_gather_bitwise_equal_to_plain(cuda, name):
    a, _ = _pair(name, 128)
    prep = ops.prepare_incrs(InCRS.from_dense(a), pad_rows_to=8, device=cuda)
    before = G.LAUNCHES["incrs_gather"]
    out = G.incrs_gather(prep.idx, prep.val, section=prep.section, bm=8)
    torch.cuda.synchronize()
    assert G.LAUNCHES["incrs_gather"] == before + 1
    assert torch.equal(out, G.plain(prep.idx, prep.val,
                                    section=prep.section, bm=8))
    assert np.array_equal(out.cpu().numpy()[:a.shape[0], :a.shape[1]], a)


def _stripes_with_repeats(seed, m, n_sec, smax, section):
    """Random section stripes (pads anywhere) in which row 1, section 0
    carries one index three times, in slots 0, 2 and smax - 1: summed in
    slot order, ((0 + 0.1) + 1e8) - 1e8 = 0."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-1, section, size=(m, n_sec, smax)).astype(np.int32)
    idx[rng.random(idx.shape) < 0.4] = -1
    val = rng.standard_normal(idx.shape).astype(np.float32)
    idx[1, 0, [0, 2, smax - 1]] = 5
    val[1, 0, [0, 2, smax - 1]] = [0.1, 1e8, -1e8]
    return torch.from_numpy(idx), torch.from_numpy(val)


def _off16(t, dev):
    """A contiguous copy of ``t`` on ``dev`` whose data sits 4 bytes past
    a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("section", [37, 256])
def test_gather_sums_a_repeat_in_slot_order_as_the_cpu_does(cuda, section):
    """An index three times in one stripe: the tile instance equals the
    CPU's plain version bit for bit, and its own repeat."""
    idx, val = _stripes_with_repeats(21, 24, 5, 40, section)
    want = G.plain(idx, val, section=section)
    assert want[1, 5] == 0.0
    before = G.INSTANCE_LAUNCHES["incrs_gather/tile"]
    out = G.incrs_gather(idx.to(cuda), val.to(cuda), section=section)
    again = G.incrs_gather(idx.to(cuda), val.to(cuda), section=section)
    torch.cuda.synchronize()
    assert G.INSTANCE_LAUNCHES["incrs_gather/tile"] == before + 2
    assert torch.equal(out.cpu(), want) and torch.equal(again, out)


GATHER_EDGES = {   # (m, n_sections, smax, section, misaligned)
    "width_37x3": (16, 3, 9, 37, None),
    "width_odd_sections": (16, 7, 20, 18, None),
    "out_off16": (24, 5, 12, 256, "out"),
    "stripes_off16": (24, 5, 12, 256, "stripes"),
    "rows_8": (8, 47, 77, 256, None),
    "batches": (16, 2, 600, 256, None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GATHER_EDGES))
def test_gather_edges_bitwise_equal_to_the_cpu(cuda, name):
    """A width that is not a multiple of 4 (the scalar stores), an output
    or stripes 4 bytes off 16, 8 rows, and items of more slots than one
    batch: the tile instance against the CPU's plain version, bit for
    bit."""
    m, n_sec, smax, section, off = GATHER_EDGES[name]
    idx, val = _stripes_with_repeats(22, m, n_sec, smax, section)
    want = G.plain(idx, val, section=section)
    di, dv = idx.to(cuda), val.to(cuda)
    if off == "stripes":
        di, dv = _off16(idx, cuda), _off16(val, cuda)
    out = None
    if off == "out":
        out = _off16(torch.full(want.shape, 7.0), cuda)
    geo = G.gather_geometry(m, n_sec, smax, section)
    assert geo.instance == "tile"
    got = G.incrs_gather(di, dv, section=section, out=out)
    torch.cuda.synchronize()
    assert out is None or got is out
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("over", [dict(instance="general"), dict(sections=1),
                                  dict(sections=2), dict(sections=47)],
                         ids=lambda d: "-".join(f"{k}{v}" for k, v in
                                                d.items()))
def test_gather_first_design_and_tiles_agree(cuda, over):
    """The first design stays reachable through a geometry override; on
    prepped stripes (no index repeats) it and the tile instance at other
    item widths equal the rule's launch bit for bit."""
    a, _ = _pair("docword4", 128)
    prep = ops.prepare_incrs(InCRS.from_dense(a), pad_rows_to=8,
                             device=cuda)
    want = G.incrs_gather(prep.idx, prep.val, section=prep.section)
    m, n_sec, smax = prep.idx.shape
    sections = min(over.get("sections", 1), n_sec)
    geo = G.gather_geometry(m, n_sec, smax, prep.section,
                            instance=over.get("instance"),
                            sections=None if "instance" in over else
                            sections)
    before = dict(G.INSTANCE_LAUNCHES)
    got = G.incrs_gather(prep.idx, prep.val, section=prep.section,
                         geometry=geo)
    torch.cuda.synchronize()
    assert G.INSTANCE_LAUNCHES[f"incrs_gather/{geo.instance}"] == \
        before[f"incrs_gather/{geo.instance}"] + 1
    assert torch.equal(got, want)


MERGE_EDGES = {   # (n_rounds, M, N, bm, bn, misaligned)
    "one_round": (1, 64, 96, 8, 8, False),
    "stripes_off16": (5, 64, 96, 8, 8, True),
    "plane_odd": (6, 35, 33, 1, 1, False),
    "many_items": (3, 512, 520, 8, 8, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(MERGE_EDGES))
def test_merge_edges_bitwise_equal_to_plain(cuda, name):
    """One round, stripes 4 bytes off 16 and a plane that is not a
    multiple of 4 (both the general instance, the rule says), and a plane
    of many chunks: bit for bit against plain merge on the card and on
    the CPU."""
    n_rounds, m, n, bm, bn, off = MERGE_EDGES[name]
    rng = np.random.default_rng(23)
    host = torch.from_numpy(rng.standard_normal((n_rounds, m, n))
                            .astype(np.float32))
    host[0, 0, :3] = torch.tensor([-0.0, 1e30, -1e30])
    stripes = _off16(host, cuda) if off else host.to(cuda)
    geo = SK.merge_geometry(m * n, n_rounds,
                            stripes.data_ptr() % 16 == 0)
    assert geo.instance == ("general" if off or (m * n) % 4 else "ring")
    before = SK.MERGE_INSTANCE_LAUNCHES[f"spgemm_merge/{geo.instance}"]
    got = SK.spgemm_merge(stripes, bm=bm, bn=bn)
    torch.cuda.synchronize()
    assert SK.MERGE_INSTANCE_LAUNCHES[f"spgemm_merge/{geo.instance}"] == \
        before + 1
    assert torch.equal(got, SK.plain_merge(stripes, bm=bm, bn=bn))
    assert torch.equal(got.cpu(), SK.plain_merge(host, bm=bm, bn=bn))


@pytest.mark.gpu
@pytest.mark.parametrize("over", [dict(instance="general"),
                                  dict(chunk=1024), dict(chunk=4),
                                  dict(chunk=8192, stages=2),
                                  dict(stages=12, chunk=2048)],
                         ids=lambda d: "-".join(f"{k}{v}" for k, v in
                                                d.items()))
def test_merge_first_design_and_rings_agree(cuda, over):
    """The first design stays reachable through a geometry override; it
    and the ring at other chunks and depths equal the rule's launch and
    the fused index matching, bit for bit."""
    a, bt = _pair("docword4", 128)
    ai, av = _prep(a, 128, 64, cuda)
    bi, bv = _prep(bt, 128, 32, cuda)
    kw = dict(rounds=128, bm=64, bn=32)
    fused = IM.index_match_spmm(ai, av, bi, bv, **kw)
    stripes = SK.spgemm_condense(ai, av, bi, bv, **kw)
    n_rounds, m, n = stripes.shape
    assert SK.merge_geometry(m * n, n_rounds).instance == "ring"
    geo = SK.merge_geometry(m * n, n_rounds, **over)
    got = SK.spgemm_merge(stripes, bm=64, bn=32, geometry=geo)
    torch.cuda.synchronize()
    assert torch.equal(got, SK.spgemm_merge(stripes, bm=64, bn=32))
    assert torch.equal(got, fused)


def _deltas(before):
    now = {**K1.LAUNCHES, **G.LAUNCHES, **IM.LAUNCHES, **SK.LAUNCHES}
    return {k: v - before[k] for k, v in now.items() if v != before[k]}


ENGINE_LAUNCHES = {
    "reference": {"index_match_spmm": 1},
    "auto": {"index_match_spmm": 1},
    "condense_merge": {"spgemm_condense": 1, "spgemm_merge": 1},
    "densify": {"incrs_gather": 1, "incrs_spmm": 1},
}


def _engine_launches(variant, a, bt, device):
    """The launches ``variant`` implies: ``auto`` those of the engine the
    cost model picks; densify's InCRS product those of the order ``auto``
    picks for it (the tuning cache being empty)."""
    from repro_torch.core import mesh_sim
    from repro_torch.kernels import autotune
    if variant == "auto":
        variant = autotune.pick_spgemm_engine(
            mesh_sim.spgemm_cost_for(a, bt, rounds=64))
    if variant != "densify":
        return dict(ENGINE_LAUNCHES[variant])
    prep = ops.prepare_incrs(ops._incrs_of(a), device=device)
    order = ops.resolve_incrs(prep, bt.shape[0])[0]
    return {"incrs_gather": 1, {"expand": "incrs_spmm",
                                "reuse": "incrs_spmm_reuse",
                                "pipelined": "incrs_spmm_pipelined"}[order]:
            1}


@pytest.mark.gpu
@pytest.mark.parametrize("variant", sorted(ENGINE_LAUNCHES))
def test_spmm_engines_launch_their_kernels(cuda, variant, monkeypatch,
                                           tmp_path):
    from repro_torch.kernels import autotune
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "tune.json"))
    autotune.clear_memory_cache()
    a, bt = _pair("ragged", 128)
    want = a.astype(np.float64) @ bt.astype(np.float64).T
    ca, cbt = CRS.from_dense(a), CRS.from_dense(bt)
    expect = _engine_launches(variant, ca, cbt, cuda)
    before = {**K1.LAUNCHES, **G.LAUNCHES, **IM.LAUNCHES, **SK.LAUNCHES}
    out = ops.spmm(ca, cbt, variant=variant, rounds=64, device=cuda)
    torch.cuda.synchronize()
    assert _deltas(before) == expect
    assert out.device.type == "cuda" and out.shape == want.shape
    assert np.abs(out.cpu().numpy() - want).max() <= \
        F64_TOL * np.abs(want).max()


@pytest.mark.gpu
def test_spgemm_entry_and_incrs_rhs(cuda):
    a, bt = _pair("ragged", 128)
    want = a.astype(np.float64) @ bt.astype(np.float64).T
    out = ops.spmm(CRS.from_dense(a), InCRS.from_dense(bt), rounds=32)
    assert out.device.type == "cuda"
    assert np.abs(out.cpu().numpy() - want).max() <= \
        F64_TOL * np.abs(want).max()
    c, est = spgemm.spgemm(CRS.from_dense(a), CRS.from_dense(bt), rounds=32,
                           output="crs")
    assert isinstance(c, CRS)
    assert np.abs(c.to_dense() - want).max() <= F64_TOL * np.abs(want).max()
    d, _ = spgemm.spgemm(CRS.from_dense(a), CRS.from_dense(bt), rounds=32,
                         output="dense")
    assert isinstance(d, torch.Tensor) and d.device.type == "cuda"
    assert np.array_equal(d.cpu().numpy(), c.to_dense())


@pytest.mark.gpu
def test_out_dtype_on_the_card(cuda):
    a, bt = _pair("docword4", 128)
    ai, av = _prep(a, 128, 128, cuda)
    bi, bv = _prep(bt, 128, 128, cuda)
    f32 = ops.index_match_prepped(ai, av, bi, bv)
    bf = ops.index_match_prepped(ai, av.bfloat16(), bi, bv.bfloat16())
    assert bf.dtype == torch.bfloat16
    forced = ops.index_match_prepped(ai, av, bi, bv,
                                     out_dtype=torch.bfloat16)
    assert torch.equal(forced, f32.bfloat16())
    cm = spgemm.condense_merge_prepped(ai, av, bi, bv,
                                       out_dtype=torch.bfloat16)
    assert torch.equal(cm, forced)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    idx = torch.full((64, 2, 4), -1, dtype=torch.int32, device=cuda)
    val = torch.zeros((64, 2, 4), device=cuda)
    with pytest.raises(TypeError):
        IM.index_match_spmm(idx.long(), val, idx, val, bm=64, bn=64)
    with pytest.raises(ValueError, match="contiguous"):
        IM.index_match_spmm(idx.transpose(1, 2).contiguous().transpose(1, 2),
                            val, idx, val, bm=64, bn=64)
    with pytest.raises(ValueError, match="shared memory"):
        IM.index_match_spmm(idx, val, idx, val, rounds=1024, bm=64, bn=64)
    with pytest.raises(ValueError, match="share one device"):
        IM.index_match_spmm(idx, val, idx.cpu(), val, bm=64, bn=64)
    with pytest.raises(ValueError, match="round counts"):
        SK.spgemm_condense(idx, val, idx[:, :1].contiguous(),
                           val[:, :1].contiguous(), bm=64, bn=64)
    with pytest.raises(TypeError):
        SK.spgemm_merge(torch.zeros((2, 64, 64), dtype=torch.float64,
                                    device=cuda), bm=64, bn=64)
    with pytest.raises(TypeError):
        G.incrs_gather(idx, val.double(), bm=8)
    off = _off16(torch.zeros((2, 64, 64)), cuda)
    with pytest.raises(ValueError, match="16 bytes"):
        SK.spgemm_merge(off, bm=64, bn=64,
                        geometry=SK.merge_geometry(64 * 64, 2))
    # 100 rounds of 16384 x 16384 f32 stripes: 107 GB, refused up front.
    big = torch.full((16384, 100, 1), -1, dtype=torch.int32, device=cuda)
    zeros = torch.zeros(big.shape, device=cuda)
    with pytest.raises(RuntimeError, match="stripe array"):
        spgemm.condense_merge_prepped(big, zeros, big, zeros)


@pytest.mark.gpu
def test_incrs_spmm_takes_a_strided_rhs_that_needs_no_padding(cuda):
    """K a multiple of the section and N of the column tile: the padding
    is empty, and a transposed B must still reach the kernel contiguous."""
    rng = np.random.default_rng(2)
    a = _sparse(rng, 48, 512, 0.05)
    b = rng.normal(size=(128, 512)).astype(np.float32)
    bt = torch.from_numpy(b).to(cuda).T
    assert not bt.is_contiguous()
    out = ops.spmm(InCRS.from_dense(a), bt, bn=128, device=cuda)
    want = a.astype(np.float64) @ b.T.astype(np.float64)
    assert np.abs(out.cpu().numpy() - want).max() <= \
        F64_TOL * np.abs(want).max()
