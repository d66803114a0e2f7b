"""The port's BSR format, sparsity selections, BSR prep and the plain
versions of the BSR and dense kernels against the JAX package, on the CPU.
The CUDA kernels themselves are tested in ``test_torch_cuda_plan.py``,
which imports no JAX.

The BSR container, the masks, the kernel block lists and the sparse-linear
metadata are equal bit for bit. Products agree within ``1e-5 * max|C|``
(the JAX kernels run in Pallas interpret mode; both sum in f32, in another
order). Output dtypes follow the JAX rules: ``b.dtype`` for BSR,
``a.dtype`` for dense.
"""
import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                   # noqa: E402

from repro.core import bsr as jbsr                        # noqa: E402
from repro.kernels import ops as jops                     # noqa: E402
from repro.sparse import linear as jlin                   # noqa: E402
from repro.sparse import pattern as jpat                  # noqa: E402
from repro_torch import convert                           # noqa: E402
from repro_torch.core import bsr as tbsr                  # noqa: E402
from repro_torch.kernels import bsr_spmm as tkb           # noqa: E402
from repro_torch.kernels import dense_mm as tkd           # noqa: E402
from repro_torch.kernels import ops as tops               # noqa: E402
from repro_torch.sparse import linear as tlin             # noqa: E402
from repro_torch.sparse import pattern as tpat            # noqa: E402

C_TOL = 1e-5       # max|port - JAX| <= C_TOL * max|C|


def _close(got, want, tol=C_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    assert float(np.abs(got - want).max(initial=0.0)) <= tol * scale


def _blocky(m, k, bm, bk, density, empty_rows=(), seed=0):
    """A dense (m, k) f32 matrix whose (bm, bk) blocks are live with
    probability ``density``; ``empty_rows`` block-rows are all zero."""
    rng = np.random.default_rng(seed)
    nbr, nbc = m // bm, k // bk
    keep = rng.random((nbr, nbc)) < density
    keep[list(empty_rows)] = False
    a = rng.normal(size=(m, k)).astype(np.float32)
    return (a.reshape(nbr, bm, nbc, bk) * keep[:, None, :, None]
            ).reshape(m, k), keep


def _same_bsr(t, j):
    assert t.shape == j.shape and t.block == j.block
    for f in ("values", "col_idx", "row_ptr"):
        x, y = getattr(t, f), getattr(j, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


OPERANDS = [  # (m, k, bm, bk, density, empty block-rows)
    (64, 96, 16, 16, 0.5, ()), (60, 100, 10, 20, 0.4, (2, 3)),
    (48, 64, 16, 32, 0.0, ()), (32, 32, 32, 32, 1.0, ()),
    (90, 120, 30, 40, 0.3, (0,))]


@pytest.mark.parametrize("case", OPERANDS, ids=lambda c: "-".join(
    map(str, c[:5])))
def test_bsr_container_matches_jax_bit_for_bit(case):
    m, k, bm, bk, d, empty = case
    a, keep = _blocky(m, k, bm, bk, d, empty)
    for th in (0.0, 0.5):
        _same_bsr(tbsr.BSR.from_dense(a, (bm, bk), th),
                  jbsr.BSR.from_dense(a, (bm, bk), th))
    t = tbsr.BSR.from_mask(a, keep, (bm, bk))
    j = jbsr.BSR.from_mask(a, keep, (bm, bk))
    _same_bsr(t, j)
    assert np.array_equal(t.to_dense(), j.to_dense())
    assert t.nnz_blocks == j.nnz_blocks
    assert t.block_density == j.block_density
    for width in (None, 7):
        for x, y in zip(t.padded(width), j.padded(width)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    for dens in (0.1, 0.5, 1.0):
        assert np.array_equal(tbsr.magnitude_block_mask(a, (bm, bk), dens),
                              jbsr.magnitude_block_mask(a, (bm, bk), dens))
    with pytest.raises(ValueError, match="divisible"):
        tbsr.BSR.from_dense(a[:-1], (bm, bk))
    with pytest.raises(ValueError, match="block grid"):
        tbsr.BSR.from_mask(a, keep[:-1], (bm, bk))


def test_magnitude_block_mask_ties_match_jax():
    a = np.ones((64, 64), np.float32)             # every score ties
    for d in (0.1, 0.3, 0.77):
        assert np.array_equal(tbsr.magnitude_block_mask(a, (16, 16), d),
                              jbsr.magnitude_block_mask(a, (16, 16), d))


@pytest.mark.parametrize("seed", [0, 1])
def test_selections_match_jax_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    w[rng.random(w.shape) < 0.3] = 0.0
    w[:16, :16] = 0.0                             # an all-zero block
    for d in (None, 0.05, 0.3, 1.0):
        assert np.array_equal(tpat.magnitude_mask(w, d),
                              jpat.magnitude_mask(w, d))
        for blk in (8, 16):
            assert np.array_equal(tpat.magnitude_mask(w, d, block=blk),
                                  jpat.magnitude_mask(w, d, block=blk))
    assert np.array_equal(tpat.magnitude_mask(w, None, policy="2:4"),
                          jpat.magnitude_mask(w, None, policy="2:4"))
    assert np.array_equal(tpat.nm_mask(w, 1, 8), jpat.nm_mask(w, 1, 8))
    assert tpat.parse_nm("3:8") == jpat.parse_nm("3:8")
    for bad in ("2-4", "5:4", "0:4"):
        with pytest.raises(ValueError):
            tpat.parse_nm(bad)
    with pytest.raises(ValueError, match="fixes density"):
        tpat.magnitude_mask(w, 0.3, policy="2:4")
    with pytest.raises(ValueError, match="element-level"):
        tpat.magnitude_mask(w, None, block=8, policy="2:4")
    mask = tpat.magnitude_mask(w, 0.3)
    tp, jp = tpat.SparsityPattern(mask), jpat.SparsityPattern(mask)
    for blk in (8, 16):
        bm = tp.block_mask(blk)
        assert np.array_equal(bm, jp.block_mask(blk))
        assert np.array_equal(tpat.expand_block_mask(bm, blk),
                              jpat.expand_block_mask(bm, blk))
    assert (tp.nnz, tp.density, tp.shape) == (jp.nnz, jp.density, jp.shape)
    nxt = tp.evolve(mask & False)
    assert nxt.uid == tp.uid and nxt.version == 1 and nxt.packed == {}
    with pytest.raises(ValueError, match="must divide"):
        tp.block_mask(7)


@pytest.mark.parametrize("case", OPERANDS + [(64, 64, 16, 16, 0.0, ())],
                         ids=lambda c: "-".join(map(str, c[:5])))
def test_bsr_kernel_meta_and_prep_match_jax(case):
    m, k, bm, bk, d, empty = case
    a, keep = _blocky(m, k, bm, bk, d, empty)
    t = tbsr.BSR.from_mask(a, keep, (bm, bk))
    j = jbsr.BSR.from_mask(a, keep, (bm, bk))
    for x, y in zip(tops.bsr_kernel_meta(t), jops.bsr_kernel_meta(j)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    *mine, starts = tops.prep_bsr(t, device="cpu")
    theirs = jops.prep_bsr(j)
    assert len(mine) == len(theirs) == 3
    for x, y in zip(mine, theirs):
        y = np.asarray(y)
        assert x.numpy().dtype == y.dtype and np.array_equal(x.numpy(), y)
    row_of = tops.bsr_kernel_meta(t)[0]
    starts = starts.numpy()
    assert starts.dtype == np.int32 and np.array_equal(
        starts, tkb.block_row_starts(row_of[:-1], t.n_block_rows))
    # every block-row has a run of at least one block (zero tiles)
    assert starts[0] == 0 and starts[-1] == len(row_of) - 1
    assert (np.diff(starts) >= 1).all()


@pytest.mark.parametrize("case", OPERANDS, ids=lambda c: "-".join(
    map(str, c[:5])))
@pytest.mark.parametrize("n", [1, 130])
def test_spmm_bsr_matches_jax(case, n):
    m, k, bm, bk, d, empty = case
    a, keep = _blocky(m, k, bm, bk, d, empty)
    b = np.random.default_rng(5).normal(size=(k, n)).astype(np.float32)
    t = tbsr.BSR.from_mask(a, keep, (bm, bk))
    j = jbsr.BSR.from_mask(a, keep, (bm, bk))
    got = tops.spmm(t, torch.from_numpy(b), device="cpu")
    want = np.asarray(jops.spmm(j, jnp.asarray(b)))
    assert got.dtype == torch.float32
    _close(got.numpy(), want)
    _close(got.numpy(), a.astype(np.float64) @ b)
    with pytest.raises(ValueError, match="inner dims"):
        tops.spmm(t, b[:-1], device="cpu")


@pytest.mark.parametrize("shape", [(1, 1, 1), (127, 129, 300),
                                   (300, 7, 129), (5, 200, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_dense_mm_matches_jax_on_ragged_shapes(shape):
    m, k, n = shape
    rng = np.random.default_rng(6)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    got = tops.dense_mm(a, b, device="cpu")
    want = np.asarray(jops.dense_mm(jnp.asarray(a), jnp.asarray(b)))
    _close(got.numpy(), want)
    _close(tops.spmm(a, b, device="cpu").numpy(), want)
    with pytest.raises(ValueError, match="inner dims"):
        tops.dense_mm(a, np.zeros((k + 1, n), np.float32), device="cpu")


def test_output_dtypes_follow_jax():
    a, keep = _blocky(32, 64, 16, 16, 0.6)
    t = tbsr.BSR.from_mask(a, keep, (16, 16))
    j = jbsr.BSR.from_mask(a, keep, (16, 16))
    b = np.random.default_rng(7).normal(size=(64, 8)).astype(np.float32)
    jb16 = jnp.asarray(b, jnp.bfloat16)
    tb16 = torch.from_numpy(b).to(torch.bfloat16)
    jout = jops.spmm(j, jb16)
    tout = tops.spmm(t, tb16, device="cpu")
    assert str(jout.dtype) == "bfloat16" and tout.dtype == torch.bfloat16
    _close(tout.float().numpy(), np.asarray(jout, np.float32), tol=1e-2)
    a16, ja16 = torch.from_numpy(a).to(torch.bfloat16), \
        jnp.asarray(a, jnp.bfloat16)
    jd = jops.dense_mm(ja16, jnp.asarray(b))
    td = tops.dense_mm(a16, torch.from_numpy(b), device="cpu")
    assert str(jd.dtype) == "bfloat16" and td.dtype == torch.bfloat16
    _close(td.float().numpy(), np.asarray(jd, np.float32), tol=1e-2)
    td = tops.dense_mm(torch.from_numpy(a), tb16, device="cpu")
    assert td.dtype == torch.float32


def test_plain_kernels_keep_the_pallas_contracts():
    a, keep = _blocky(40, 60, 20, 30, 0.5, empty_rows=(1,))
    t = tbsr.BSR.from_mask(a, keep, (20, 30))
    row_of, col_of, values, rs = tops.prep_bsr(t, device="cpu")
    b = torch.randn(60, 5, generator=torch.Generator().manual_seed(0))
    out = tkb.bsr_spmm(row_of, col_of, values, b, n_block_rows=2,
                       row_start=rs)
    _close(out.numpy(), a.astype(np.float64) @ b.numpy())
    with pytest.raises(ValueError, match="sentinel"):
        tkb.bsr_spmm(row_of[:-1], col_of, values, b, n_block_rows=2,
                     row_start=rs)
    with pytest.raises(ValueError, match="multiple of the block side"):
        tkb.bsr_spmm(row_of, col_of, values, b[:50], n_block_rows=2,
                     row_start=rs)
    with pytest.raises(ValueError, match="row_start"):
        tkb.bsr_spmm(row_of, col_of, values, b, n_block_rows=2,
                     row_start=rs[:-1])
    with pytest.raises(ValueError, match="contract"):
        tkd.dense_mm(b, b)


@pytest.mark.parametrize("d", [0.0, 0.3, 1.0])
def test_bsr_linear_meta_matches_jax_field_for_field(d):
    rng = np.random.default_rng(8)
    w = rng.normal(size=(64, 96)).astype(np.float32)
    wt = np.ascontiguousarray(w.T)
    mask = jbsr.magnitude_block_mask(wt, (16, 16), d) if d else \
        np.zeros((6, 4), bool)
    if d == 0.0:
        mask[1, 2] = True                         # most block-rows empty
    jp = jlin._bsr_from_mask(w, mask, 16)
    tp = tlin._bsr_from_mask(w, mask, 16, device="cpu")
    for f in ("d_in", "d_out", "block", "row_of", "col_of", "vpos",
              "t_perm", "t_row_of", "t_col_of", "t_vpos"):
        assert getattr(tp.meta, f) == getattr(jp.meta, f), f
    assert (tp.meta.nnz, tp.meta.n_block_rows, tp.meta.n_block_rows_t) == \
        (jp.meta.nnz, jp.meta.n_block_rows, jp.meta.n_block_rows_t)
    assert np.array_equal(tp.values.numpy(), np.asarray(jp.values))
    assert np.array_equal(tp.meta.pattern.mask, jp.meta.pattern.mask)
    assert tp.meta.pattern.packed["bsr"] is tp.meta
    for x, y in zip(tlin.real_blocks(tp.meta), jlin.real_blocks(jp.meta)):
        assert np.array_equal(x, y)
    assert np.array_equal(tlin.to_dense(tp), np.asarray(jlin.to_dense(jp)))
    assert np.array_equal(tlin._bsr_pack_values(tp.meta, w),
                          np.asarray(jlin._bsr_pack_values(jp.meta, w)))
    x = rng.normal(size=(5, 64)).astype(np.float32)
    y = tlin._bsr_apply(tp, torch.from_numpy(x))
    _close(y.numpy(), np.asarray(jlin._bsr_apply(jp, jnp.asarray(x))))
    # the device index lists are made once and kept on the meta
    first = tp.meta.kernel_index(torch.device("cpu"))
    assert tp.meta.kernel_index(torch.device("cpu")) is first


def test_bsr_from_arrays_round_trips_a_jax_bsr():
    a, keep = _blocky(60, 100, 10, 20, 0.4, (2,))
    j = jbsr.BSR.from_mask(a, keep, (10, 20))
    t = convert.bsr_from_arrays(j.values, j.col_idx, j.row_ptr, j.shape,
                                j.block)
    _same_bsr(t, j)
    with pytest.raises(ValueError, match="disagree"):
        convert.bsr_from_arrays(j.values, j.col_idx, j.row_ptr[:-1],
                                j.shape, j.block)
