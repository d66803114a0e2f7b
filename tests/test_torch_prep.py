"""The port's host prep against the JAX package's, bit for bit: synthetic
Table II datasets, InCRS counter words and prep_sections stripes."""
import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401

torch = pytest.importorskip("torch")

from repro.core.incrs import InCRS as JInCRS          # noqa: E402
from repro.data import datasets as jdata              # noqa: E402
from repro.kernels import ops as jops                 # noqa: E402
from repro_torch import convert                       # noqa: E402
from repro_torch.configs.paper_spmm import WORKLOADS  # noqa: E402
from repro_torch.core import incrs as tincrs          # noqa: E402
from repro_torch.core.incrs import InCRS as TInCRS    # noqa: E402
from repro_torch.data import datasets as tdata        # noqa: E402
from repro_torch.kernels import ops as tops           # noqa: E402

TABLE2 = sorted(jdata.TABLE2_DATASETS)
TABLES = {**jdata.TABLE2_DATASETS, **jdata.TABLE4_DATASETS}


def _edge_dense(kind):
    """The edge operands: M not a multiple of 8, empty rows, smax = 1, a
    fully dense section, K not a multiple of the section."""
    rng = np.random.default_rng(11)

    def sparse(m, k, d):
        a = rng.uniform(0.5, 1.5, size=(m, k)).astype(np.float32)
        a[rng.random(size=(m, k)) >= d] = 0.0
        return a

    if kind == "m_ragged":
        return sparse(29, 600, 0.05)
    if kind == "empty_rows":
        a = sparse(24, 700, 0.05)
        a[3] = 0.0
        a[10:14] = 0.0
        return a
    if kind == "smax_1":
        a = np.zeros((16, 768), np.float32)
        for r in range(16):
            for s in range(0, 3, 1 + r % 2):
                a[r, s * 256 + rng.integers(256)] = 1.0 + r
        return a
    if kind == "dense_section":
        a = sparse(12, 600, 0.03)
        a[:, 256:512] = rng.uniform(0.5, 1.5, size=(12, 256))
        return a
    if kind == "k_ragged":
        return sparse(20, 300, 0.1)
    raise ValueError(kind)


EDGES = ["m_ragged", "empty_rows", "smax_1", "dense_section", "k_ragged"]


def _assert_crs_equal(t, j):
    assert t.shape == j.shape
    for f in ("values", "col_idx", "row_ptr"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", TABLE2 + sorted(jdata.TABLE4_DATASETS))
def test_synthesize_matches_jax(name):
    spec = jdata.scaled(TABLES[name], 0.06)
    tspec = tdata.scaled({**tdata.TABLE2_DATASETS,
                          **tdata.TABLE4_DATASETS}[name], 0.06)
    assert tspec == tdata.DatasetSpec(*[getattr(spec, f) for f in
                                        ("name", "m", "n", "density",
                                         "row_nnz", "skew")])
    for seed in (0, 3):
        _assert_crs_equal(tdata.synthesize(tspec, seed),
                          jdata.synthesize(spec, seed))


def test_workloads_match_jax():
    from repro.configs.paper_spmm import WORKLOADS as JW
    assert sorted(WORKLOADS) == sorted(JW)
    for k, w in WORKLOADS.items():
        jw = JW[k]
        assert (w.name, w.mesh_n, w.rounds, w.section, w.block) == \
            (jw.name, jw.mesh_n, jw.rounds, jw.section, jw.block)
        assert (w.dataset.m, w.dataset.n, w.dataset.density,
                w.dataset.row_nnz) == (jw.dataset.m, jw.dataset.n,
                                       jw.dataset.density,
                                       jw.dataset.row_nnz)


def _operands():
    for name in TABLE2:
        spec = jdata.scaled(jdata.TABLE2_DATASETS[name], 0.06)
        yield name, jdata.synthesize(spec, 0).to_dense()
    for kind in EDGES:
        yield kind, _edge_dense(kind)


OPERANDS = dict(_operands())


@pytest.mark.parametrize("name", sorted(OPERANDS))
def test_counters_match_jax(name):
    dense = OPERANDS[name]
    j = JInCRS.from_dense(dense)
    t = TInCRS.from_dense(dense)
    _assert_crs_equal(t.crs, j.crs)
    assert t.counters.dtype == np.uint32
    np.testing.assert_array_equal(t.counters, j.counters)
    for a, b in zip(t.counters_unpacked(), j.counters_unpacked()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(OPERANDS))
@pytest.mark.parametrize("pad", [1, 8, 128])
def test_prep_sections_match_jax(name, pad):
    dense = OPERANDS[name]
    j = JInCRS.from_dense(dense)
    ji, jv = (np.asarray(x) for x in jops.prep_sections(j, pad_rows_to=pad))
    ti, tv = tops.prep_sections(TInCRS.from_dense(dense), pad_rows_to=pad,
                                device="cpu")
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tv.numpy(), jv)
    if name == "smax_1":
        assert ti.shape[2] == 1
    if name == "dense_section":
        assert ti.shape[2] == 256


def test_pack_unpack_match_jax():
    from repro.core import incrs as jincrs
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, 1 << 16, size=(7, 5))
    blocks = rng.integers(0, 33, size=(7, 5, 8))
    for a, b in zip(tincrs._pack64(prefix, blocks),
                    jincrs._pack64(prefix, blocks)):
        np.testing.assert_array_equal(a, b)
    lo, hi = tincrs._pack64(prefix, blocks)
    p, bl = tincrs._unpack64(lo, hi, 8)
    np.testing.assert_array_equal(p, prefix)
    np.testing.assert_array_equal(bl, blocks)
    with pytest.raises(ValueError):
        tincrs._pack64(prefix, rng.integers(0, 3, size=(7, 5, 9)))


def test_convert_roundtrips_jax_operand():
    dense = OPERANDS["docword"]
    j = JInCRS.from_dense(dense, section=128, block=16)
    t = convert.incrs_from_arrays(j.crs.values, j.crs.col_idx,
                                  j.crs.row_ptr, j.shape, j.counters,
                                  j.section, j.block)
    assert (t.section, t.block, t.shape) == (128, 16, j.shape)
    np.testing.assert_array_equal(t.counters, j.counters)
    ji, jv = jops.prep_sections(j, pad_rows_to=8)
    prep = convert.prepared_from_arrays(ji, jv, j.shape, j.section,
                                        device="cpu")
    ti, tv = tops.prep_sections(t, pad_rows_to=8, device="cpu")
    assert torch.equal(prep.idx, ti) and torch.equal(prep.val, tv)
    assert prep.shape == j.shape and prep.section == 128
    with pytest.raises(ValueError):
        convert.incrs_from_arrays(j.crs.values, j.crs.col_idx,
                                  j.crs.row_ptr, j.shape,
                                  j.counters.astype(np.int64), 128, 16)
    with pytest.raises(ValueError):
        convert.prepared_from_arrays(np.asarray(ji).astype(np.int64), jv,
                                     j.shape, 128, device="cpu")


def test_prepare_incrs_memo_is_lru_and_invalidates():
    dense = OPERANDS["norris"]
    inc = TInCRS.from_dense(dense)
    p1 = tops.prepare_incrs(inc, device="cpu")
    assert tops.prepare_incrs(inc, device="cpu") is p1
    assert p1.padded_rows % 128 == 0 and p1.device.type == "cpu"
    tops.invalidate_prepared(inc)
    p2 = tops.prepare_incrs(inc, device="cpu")
    assert p2 is not p1
    assert torch.equal(p2.idx, p1.idx)
    other = TInCRS.from_dense(dense)
    assert tops.prepare_incrs(other, device="cpu") is not p2
    key = [k for k in tops._PREP_CACHE if k[0] == id(other)]
    del other
    assert all(k not in tops._PREP_CACHE for k in key)
