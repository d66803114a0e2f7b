"""The port's sparse × sparse path (``prep_rounds``, the plain versions of
index matching, condense, merge and the InCRS gather, the three SpGEMM
engines and ``spgemm.spgemm``) against the JAX package, on the CPU. The
CUDA kernels themselves are tested in ``test_torch_cuda_spgemm.py``, which
imports no JAX.

Tolerance against JAX: rtol = atol = 1e-4, the JAX package's own bound for
f32 (the two sum the same products in another order). Preps, the gather
and the output-density estimate are equal bit for bit, and so are the
port's plain condense + merge and its plain index matching. The JAX
densify engine runs ``_spmm_incrs(variant="auto")``, which does not trace
on the installed jax (ROADMAP fault C1), so the port's densify engine is
held against JAX ``incrs_to_dense`` and ``_spmm_incrs(variant="expand")``
composed by hand.
"""
import gc
import warnings
import weakref

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                   # noqa: E402

from repro import spgemm as jspgemm                       # noqa: E402
from repro.core.crs import CRS as JCRS                    # noqa: E402
from repro.core.incrs import InCRS as JInCRS              # noqa: E402
from repro.kernels import incrs_gather as jgather         # noqa: E402
from repro.kernels import ops as jops                     # noqa: E402
from repro_torch import convert                           # noqa: E402
from repro_torch import spgemm as tspgemm                 # noqa: E402
from repro_torch.core.crs import CRS as TCRS              # noqa: E402
from repro_torch.core.incrs import InCRS as TInCRS        # noqa: E402
from repro_torch.kernels import incrs_gather as tgather   # noqa: E402
from repro_torch.kernels import index_match_spmm as tim   # noqa: E402
from repro_torch.kernels import ops as tops               # noqa: E402
from repro_torch.kernels import ref as tref               # noqa: E402
from repro_torch.spgemm import kernels as tsk             # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = "cpu"


def _dense_pair(seed, m, n, k, da, db=None):
    """Dense f32 A (m, k) and Bt (n, k) from a numpy seed, as
    tests/test_spgemm.py builds them."""
    rng = np.random.default_rng(seed)
    db = da if db is None else db
    a = (rng.random((m, k)) < da) * rng.standard_normal((m, k))
    bt = (rng.random((n, k)) < db) * rng.standard_normal((n, k))
    return a.astype(np.float32), bt.astype(np.float32)


def _both(dense):
    """The same operand as a JAX CRS and, through ``convert``, the
    port's."""
    j = JCRS.from_dense(dense)
    t = convert.crs_from_arrays(j.values, j.col_idx, j.row_ptr, j.shape)
    return j, t


def _bits_equal(x, y):
    assert x.dtype == y.dtype and x.shape == y.shape
    assert (x.view(np.uint32) == y.view(np.uint32)).all()


# ----------------------------------------------------------------------
PREP_CASES = [(0.0, 32), (0.03, 32), (0.5, 32), (0.03, 128), (0.5, 128)]


@pytest.mark.parametrize("pad", [1, 8, 128])
@pytest.mark.parametrize("density,rounds", PREP_CASES)
def test_prep_rounds_matches_jax_bit_for_bit(density, rounds, pad):
    a, _ = _dense_pair(1, 24, 40, 300, density)
    j, t = _both(a)
    ji, jv = (np.asarray(x) for x in jops.prep_rounds(j, rounds,
                                                      pad_rows_to=pad))
    ti, tv = tops.prep_rounds(t, rounds, pad_rows_to=pad, device=CPU)
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), ji)
    _bits_equal(tv.numpy(), jv)
    # a roomier rmax and another value type, as the caller asks
    ji, jv = (np.asarray(x) for x in jops.prep_rounds(
        j, rounds, rmax=rounds, pad_rows_to=pad, dtype=np.float16))
    ti, tv = tops.prep_rounds(t, rounds, rmax=rounds, pad_rows_to=pad,
                              dtype=torch.float16, device=CPU)
    np.testing.assert_array_equal(ti.numpy(), ji)
    assert tv.dtype == torch.float16
    np.testing.assert_array_equal(tv.numpy().view(np.uint16),
                                  jv.view(np.uint16))


def test_prep_rounds_overflow_matches_jax():
    a, _ = _dense_pair(2, 16, 16, 256, 0.5)
    j, t = _both(a)
    with pytest.raises(ValueError, match="rmax"):
        jops.prep_rounds(j, 32, rmax=4)
    with pytest.raises(ValueError, match="rmax"):
        tops.prep_rounds(t, 32, rmax=4, device=CPU)
    with pytest.raises(ValueError, match="on_overflow"):
        tops.prep_rounds(t, 32, on_overflow="bogus", device=CPU)
    with pytest.warns(UserWarning, match="dropping") as jw:
        ji, jv = jops.prep_rounds(j, 32, rmax=4, on_overflow="drop")
    with pytest.warns(UserWarning, match="dropping") as tw:
        ti, tv = tops.prep_rounds(t, 32, rmax=4, on_overflow="drop",
                                  device=CPU)
    assert str(tw[0].message) == str(jw[0].message)
    assert tw[0].filename == __file__        # blamed on the caller
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _bits_equal(tv.numpy(), np.asarray(jv))
    assert ti.shape[2] == 4


# ----------------------------------------------------------------------
@pytest.mark.parametrize("rounds", [32, 128])
@pytest.mark.parametrize("density", [0.03, 0.5])
def test_index_match_matches_jax(density, rounds):
    a, bt = _dense_pair(3, 24, 40, 200, density)
    (ja, ta), (jb, tb) = _both(a), _both(bt)
    want = np.asarray(jops._spmm_index_match(ja, jb, rounds=rounds, bm=8,
                                             bn=8))
    got = tops._spmm_index_match(ta, tb, rounds=rounds, bm=8, bn=8,
                                 device=CPU)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), a @ bt.T, **TOL)


def test_index_match_plain_from_jax_prep():
    """The plain kernel fed JAX's own per-round prep (``convert``), and
    the dense oracle of ``ref``, against the JAX kernel."""
    a, bt = _dense_pair(4, 16, 24, 150, 0.1)
    ja, jb = JCRS.from_dense(a), JCRS.from_dense(bt)
    jai, jav = jops.prep_rounds(ja, 32, pad_rows_to=8)
    jbi, jbv = jops.prep_rounds(jb, 32, pad_rows_to=8, rmax=12)
    want = np.asarray(jops.index_match_prepped(jai, jav, jbi, jbv,
                                               rounds=32, bm=8, bn=8))
    ai, av = convert.rounds_from_arrays(jai, jav, device=CPU)
    bi, bv = convert.rounds_from_arrays(jbi, jbv, device=CPU)
    got = tops.index_match_prepped(ai, av, bi, bv, rounds=32, bm=8, bn=8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ai, av, bi, bv = tops.pad_common_rmax(ai, av, bi, bv)
    assert ai.shape[2] == bi.shape[2] == 12
    oracle = tref.index_match_spmm(ai, av, bi, bv, 150, 32)
    np.testing.assert_allclose(oracle.numpy(), want, **TOL)
    with pytest.raises(ValueError):
        convert.rounds_from_arrays(np.asarray(jai).astype(np.int64), jav,
                                   device=CPU)


@pytest.mark.parametrize("rounds", [32, 128])
@pytest.mark.parametrize("density", [0.0, 0.03, 0.5])
def test_plain_condense_merge_bitwise_equal_to_index_match(density, rounds):
    a, bt = _dense_pair(0, 24, 40, 200, density)
    ta, tb = TCRS.from_dense(a), TCRS.from_dense(bt)
    ref = tops._spmm_index_match(ta, tb, rounds=rounds, bm=8, bn=8,
                                 device=CPU)
    out = tops._spmm_spgemm(ta, tb, rounds=rounds, bm=8, bn=8,
                            variant="condense_merge", device=CPU)
    _bits_equal(out.numpy(), ref.numpy())
    np.testing.assert_allclose(out.numpy(), a @ bt.T, **TOL)
    if density == 0.0:
        assert not out.any()


def test_condense_merge_plain_versions_match_jax_kernels():
    a, bt = _dense_pair(5, 16, 16, 100, 0.2)
    ja, jb = JCRS.from_dense(a), JCRS.from_dense(bt)
    jai, jav = jops.prep_rounds(ja, 32, pad_rows_to=8)
    jbi, jbv = jops.prep_rounds(jb, 32, pad_rows_to=8)
    rmax = max(jai.shape[2], jbi.shape[2])
    jai = jnp.pad(jai, ((0, 0), (0, 0), (0, rmax - jai.shape[2])),
                  constant_values=-1)
    jav = jnp.pad(jav, ((0, 0), (0, 0), (0, rmax - jav.shape[2])))
    jbi = jnp.pad(jbi, ((0, 0), (0, 0), (0, rmax - jbi.shape[2])),
                  constant_values=-1)
    jbv = jnp.pad(jbv, ((0, 0), (0, 0), (0, rmax - jbv.shape[2])))
    js = jspgemm.spgemm_condense(jai, jav, jbi, jbv, rounds=32, bm=8, bn=8,
                                 interpret=True)
    ai, av = convert.rounds_from_arrays(jai, jav, device=CPU)
    bi, bv = convert.rounds_from_arrays(jbi, jbv, device=CPU)
    ts = tsk.spgemm_condense(ai, av, bi, bv, rounds=32, bm=8, bn=8)
    assert ts.shape == js.shape and ts.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    jc = jspgemm.spgemm_merge(js, bm=8, bn=8, interpret=True)
    tc = tsk.spgemm_merge(torch.from_numpy(np.asarray(js).copy()), bm=8,
                          bn=8)
    _bits_equal(tc.numpy(), np.asarray(jc))     # same stripes, same order
    with pytest.raises(ValueError, match="align"):
        tsk.spgemm_merge(ts[:, :12], bm=8, bn=8)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("bm", [8, 16])
def test_gather_matches_jax_incrs_to_dense_bit_for_bit(bm):
    a, _ = _dense_pair(6, 29, 1, 700, 0.05)
    ja = JInCRS.from_dense(a)
    ta = TInCRS.from_dense(a)
    want = np.asarray(jops.incrs_to_dense(ja, bm=bm))
    got = tops.incrs_to_dense(ta, bm=bm, device=CPU)
    _bits_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), a)
    prep = tops.prepare_incrs(ta, pad_rows_to=bm, device=CPU)
    before = tgather.LAUNCHES["incrs_gather"]
    full = tgather.incrs_gather(prep.idx, prep.val, section=256, bm=bm)
    assert tgather.LAUNCHES["incrs_gather"] == before  # no kernel on CPU
    assert full.shape == (prep.padded_rows, prep.n_sections * 256)
    with pytest.raises(ValueError, match="multiple of bm"):
        tgather.incrs_gather(prep.idx[:prep.padded_rows - 1],
                             prep.val[:prep.padded_rows - 1], bm=bm)


def _stripes_with_repeats(seed, m, n_sec, smax, section):
    """Random section stripes (pads anywhere) in which row 1, section 0
    carries one index three times, in slots 0, 2 and smax - 1."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-1, section, size=(m, n_sec, smax)).astype(np.int32)
    idx[rng.random(idx.shape) < 0.4] = -1
    val = rng.standard_normal(idx.shape).astype(np.float32)
    idx[1, 0, [0, 2, smax - 1]] = 5
    val[1, 0, [0, 2, smax - 1]] = [0.1, 1e8, -1e8]
    return idx, val


def _slot_order(idx, val, section):
    """The dense rows, each element the sum of its values in slot order
    from 0 in f32."""
    m, n_sec, smax = idx.shape
    out = np.zeros((m, n_sec * section), np.float32)
    for r, s, q in np.ndindex(m, n_sec, smax):
        if 0 <= idx[r, s, q] < section:
            c = s * section + idx[r, s, q]
            out[r, c] = np.float32(out[r, c] + val[r, s, q])
    return out


def test_gather_sums_a_repeated_index_in_slot_order():
    """The plain version adds an index that repeats in a stripe in slot
    order, ((0 + 0.1) + 1e8) - 1e8 = 0: what the tile kernel is held to on
    the card; the JAX kernel (interpret mode) agrees within TOL but at the
    repeat, where its one-hot sum takes its own order. ``out``
    takes the result in place, a view off 16 bytes included."""
    idx, val = _stripes_with_repeats(11, 16, 3, 9, 37)
    want = _slot_order(idx, val, 37)
    assert want[1, 5] == 0.0
    ti, tv = torch.from_numpy(idx), torch.from_numpy(val)
    got = tgather.incrs_gather(ti, tv, section=37, bm=8)
    _bits_equal(got.numpy(), want)
    jgot = jgather.incrs_gather(jnp.asarray(idx), jnp.asarray(val),
                                section=37, bm=8, interpret=True)
    jgot = np.array(jgot)
    assert jgot[1, 5] in (np.float32(0.0), np.float32(0.1))  # its order
    jgot[1, 5] = want[1, 5]
    np.testing.assert_allclose(jgot, want, **TOL)
    buf = torch.full((16 * 111 + 1,), 7.0)
    view = buf[1:].view(16, 111)
    assert view.data_ptr() % 16 and \
        tgather.incrs_gather(ti, tv, section=37, bm=8, out=view) is view
    _bits_equal(view.numpy(), want)
    with pytest.raises(ValueError, match="out must be"):
        tgather.incrs_gather(ti, tv, section=37, bm=8,
                             out=torch.empty(16, 110))


def test_geometry_overrides_do_not_reach_the_cpu():
    """On the CPU the plain versions run whatever launch is asked for."""
    idx, val = _stripes_with_repeats(12, 8, 2, 4, 16)
    ti, tv = torch.from_numpy(idx), torch.from_numpy(val)
    geo = tgather.gather_geometry(8, 2, 4, 16, instance="general")
    _bits_equal(tgather.incrs_gather(ti, tv, section=16, geometry=geo)
                .numpy(), _slot_order(idx, val, 16))
    stripes = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, 8, 8)).astype(np.float32))
    geo = tsk.merge_geometry(64, 5, instance="general")
    before = dict(tsk.MERGE_INSTANCE_LAUNCHES)
    _bits_equal(tsk.spgemm_merge(stripes, bm=8, bn=8, geometry=geo).numpy(),
                tsk.plain_merge(stripes, bm=8, bn=8).numpy())
    assert tsk.MERGE_INSTANCE_LAUNCHES == before


def test_densify_engine_matches_jax_composed_by_hand():
    a, bt = _dense_pair(7, 40, 24, 300, 0.08, 0.15)
    (ja, ta), (jb, tb) = _both(a), _both(bt)
    dense_b = jops.incrs_to_dense(JInCRS.from_crs(jb)).T
    want = np.asarray(jops._spmm_incrs(JInCRS.from_crs(ja), dense_b,
                                       variant="expand"))
    got = tops._spmm_spgemm(ta, tb, variant="densify", device=CPU)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), a @ bt.T, **TOL)


@pytest.mark.parametrize("variant", ["condense_merge", "densify", "auto",
                                     "reference"])
def test_engines_match_the_dense_oracle(variant):
    a, bt = _dense_pair(8, 40, 24, 300, 0.08, 0.15)
    out = tops._spmm_spgemm(TCRS.from_dense(a), TCRS.from_dense(bt),
                            variant=variant, rounds=64, bm=8, bn=8,
                            device=CPU)
    np.testing.assert_allclose(out.numpy(), a @ bt.T, rtol=1e-3, atol=1e-3)


def test_spmm_front_door_contract():
    a, bt = _dense_pair(9, 16, 16, 128, 0.1)
    (ja, ta), (jb, tb) = _both(a), _both(bt)
    want = np.asarray(jops.spmm(ja, JInCRS.from_crs(jb), rounds=32))
    got = tops.spmm(ta, TInCRS.from_crs(tb), rounds=32, device=CPU)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(TypeError, match="sparse x sparse"):
        tops.spmm(ta, torch.from_numpy(bt.T.copy()), device=CPU)
    with pytest.raises(ValueError, match="variant"):
        tops._spmm_spgemm(ta, tb, variant="bogus", device=CPU)
    with pytest.raises(ValueError, match="inner dims"):
        tops.spmm(ta, TCRS.from_dense(bt[:, :64]), device=CPU)


def test_incrs_memo_follows_the_operand():
    t = TCRS.from_dense(_dense_pair(10, 8, 1, 64, 0.2)[0])
    inc = tops._incrs_of(t)
    assert tops._incrs_of(t) is inc
    np.testing.assert_array_equal(inc.counters,
                                  TInCRS.from_crs(t).counters)
    dead = weakref.ref(inc)
    del t, inc
    gc.collect()
    assert dead() is None          # the memo does not keep the operand


def test_out_dtype_contract():
    a, bt = _dense_pair(11, 16, 16, 128, 0.1)
    ja, jb = JCRS.from_dense(a), JCRS.from_dense(bt)
    ai, av = tops.prep_rounds(TCRS.from_dense(a), 32, pad_rows_to=8,
                              device=CPU)
    bi, bv = tops.prep_rounds(TCRS.from_dense(bt), 32, pad_rows_to=8,
                              device=CPU)
    out = tops.index_match_prepped(ai, av, bi, bv, rounds=32, bm=8, bn=8)
    assert out.dtype == torch.float32
    out16 = tops.index_match_prepped(ai, av.bfloat16(), bi, bv.bfloat16(),
                                     rounds=32, bm=8, bn=8)
    assert out16.dtype == torch.bfloat16
    jai, jav = jops.prep_rounds(ja, 32, pad_rows_to=8)
    jbi, jbv = jops.prep_rounds(jb, 32, pad_rows_to=8)
    j16 = jops.index_match_prepped(jai, jav.astype(jnp.bfloat16), jbi,
                                   jbv.astype(jnp.bfloat16), rounds=32,
                                   bm=8, bn=8)
    np.testing.assert_allclose(out16.float().numpy(),
                               np.asarray(j16, np.float32), **TOL)
    np.testing.assert_allclose(out16.float().numpy()[:16, :16], a @ bt.T,
                               rtol=0.05, atol=0.05)
    forced = tops.index_match_prepped(ai, av, bi, bv, rounds=32, bm=8,
                                      bn=8, out_dtype=torch.bfloat16)
    assert torch.equal(forced, out.bfloat16())
    cm = tspgemm.condense_merge_prepped(ai, av, bi, bv, rounds=32, bm=8,
                                        bn=8, out_dtype=torch.bfloat16)
    assert torch.equal(cm, forced)
    with pytest.raises(ValueError, match="align"):
        tim.index_match_spmm(ai[:12], av[:12], bi, bv, rounds=32, bm=8,
                             bn=8)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("density", [0.005, 0.1, 0.6])
def test_output_density_estimate_equals_jax(density):
    a, bt = _dense_pair(12, 32, 24, 512, density)
    (ja, ta), (jb, tb) = _both(a), _both(bt)
    for rounds in (32, 128):
        assert tspgemm.estimate_output_density(ta, tb, rounds) == \
            jspgemm.estimate_output_density(ja, jb, rounds)


def test_spgemm_entry_returns_what_jax_returns():
    for density in (0.01, 0.6):
        a, bt = _dense_pair(13, 16, 16, 512, density)
        (ja, ta), (jb, tb) = _both(a), _both(bt)
        jout, jest = jspgemm.spgemm(ja, jb, rounds=32, bm=8, bn=8)
        tout, test = tspgemm.spgemm(ta, tb, rounds=32, bm=8, bn=8,
                                    device=CPU)
        assert test == jest
        if isinstance(jout, JCRS):
            assert isinstance(tout, TCRS)
            np.testing.assert_array_equal(tout.col_idx, jout.col_idx)
            np.testing.assert_array_equal(tout.row_ptr, jout.row_ptr)
            np.testing.assert_allclose(tout.values, jout.values, **TOL)
        else:
            assert isinstance(tout, torch.Tensor)
            np.testing.assert_allclose(tout.numpy(), jout, **TOL)
    dense, _ = tspgemm.spgemm(ta, tb, rounds=32, bm=8, bn=8, output="dense",
                              device=CPU)
    crs, _ = tspgemm.spgemm(ta, tb, rounds=32, bm=8, bn=8, output="crs",
                            device=CPU)
    np.testing.assert_array_equal(crs.to_dense(), dense.numpy())
    with pytest.raises(ValueError, match="output"):
        tspgemm.spgemm(ta, tb, output="bogus", device=CPU)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = TCRS.from_dense(_dense_pair(14, 8, 1, 64, 0.2)[0])
    calls = [lambda: tops.prep_rounds(a, 32),
             lambda: tops.spmm(a, a),
             lambda: tops.spmm(a, a, variant="condense_merge"),
             lambda: tops.spmm(a, a, variant="densify"),
             lambda: tops.incrs_to_dense(TInCRS.from_crs(a)),
             lambda: tspgemm.spgemm(a, a)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_convert_crs_from_arrays():
    j = JCRS.from_dense(_dense_pair(15, 6, 1, 40, 0.3)[0])
    t = convert.crs_from_arrays(j.values, j.col_idx, j.row_ptr, j.shape)
    assert t.shape == j.shape and t.col_idx.dtype == np.int32
    np.testing.assert_array_equal(t.to_dense(), j.to_dense())
    with pytest.raises(ValueError):
        convert.crs_from_arrays(j.values, j.col_idx, j.row_ptr[:-1],
                                j.shape)


def test_no_warning_on_the_plain_path():
    a, bt = _dense_pair(16, 16, 16, 128, 0.1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tops.spmm(TCRS.from_dense(a), TCRS.from_dense(bt), rounds=32,
                  device=CPU)
