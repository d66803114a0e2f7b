"""The port's InCRS SpMM (kernels' plain versions and ``ops.spmm``) against
the JAX package, on the CPU. The CUDA kernels themselves are tested in
``test_torch_cuda_kernels.py``, which imports no JAX.

Tolerance against JAX: rtol = atol = 1e-4, the JAX package's own bound
for f32 (the two sum the same terms in another order). The JAX pipelined
kernel does not trace on the installed jax (ROADMAP fault C1), so the
port's pipelined order is held against JAX ``incrs_spmm``.
"""
import functools

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                   # noqa: E402

from repro.core.incrs import InCRS as JInCRS              # noqa: E402
from repro.data import datasets as jdata                  # noqa: E402
from repro.kernels import incrs_spmm as jk                # noqa: E402
from repro.kernels import ops as jops                     # noqa: E402
from repro_torch import convert                           # noqa: E402
from repro_torch.core.incrs import InCRS as TInCRS        # noqa: E402
from repro_torch.kernels import incrs_spmm as tk          # noqa: E402
from repro_torch.kernels import ops as tops               # noqa: E402
from repro_torch.kernels import ref as tref               # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
PORT = ("incrs_spmm", "incrs_spmm_reuse", "incrs_spmm_pipelined")


def _sparse(rng, m, k, d):
    a = rng.uniform(0.5, 1.5, size=(m, k)).astype(np.float32)
    a[rng.random(size=(m, k)) >= d] = 0.0
    return a


@functools.lru_cache(maxsize=None)
def _operand(name):
    rng = np.random.default_rng(3)
    if name == "docword":
        spec = jdata.scaled(jdata.TABLE2_DATASETS["docword"], 0.06)
        return jdata.synthesize(spec, 0).to_dense()
    if name == "m_ragged":
        return _sparse(rng, 29, 600, 0.05)
    if name == "dense_section":
        a = _sparse(rng, 12, 600, 0.03)
        a[:, 256:512] = rng.uniform(0.5, 1.5, size=(12, 256))
        return a
    if name == "k_ragged":
        a = _sparse(rng, 20, 300, 0.1)
        a[4] = 0.0
        return a
    raise ValueError(name)


# (operand, bm, bn, n): small enough for Pallas interpret mode.
CASES = [("docword", 16, 128, 256), ("docword", 128, 256, 256),
         ("m_ragged", 8, 64, 64), ("dense_section", 8, 128, 128),
         ("k_ragged", 16, 32, 64)]


@functools.lru_cache(maxsize=None)
def _case(operand, bm, bn, n):
    """Stripes from the JAX prep, a seeded B, and the two JAX orders."""
    dense = _operand(operand)
    j = JInCRS.from_dense(dense)
    idx, val = (np.array(x) for x in jops.prep_sections(j, pad_rows_to=1))
    k = idx.shape[1] * j.section
    b = np.random.default_rng(9).normal(size=(k, n)).astype(np.float32)
    outs = {f.__name__: np.asarray(f(jnp.asarray(idx), jnp.asarray(val),
                                     jnp.asarray(b), section=j.section,
                                     bm=bm, bn=bn, interpret=True))
            for f in (jk.incrs_spmm, jk.incrs_spmm_reuse)}
    return idx, val, b, outs


@pytest.mark.parametrize("name", PORT)
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_versions_match_jax(name, case):
    idx, val, b, jout = _case(*case)
    _, bm, bn, _ = case
    before = dict(tk.LAUNCHES)
    out = getattr(tk, name)(torch.from_numpy(idx), torch.from_numpy(val),
                            torch.from_numpy(b), section=256, bm=bm, bn=bn)
    assert tk.LAUNCHES == before          # CPU tensors never launch
    assert out.dtype == torch.float32 and out.shape == (idx.shape[0], b.shape[1])
    np.testing.assert_allclose(out.numpy(), jout["incrs_spmm"], **TOL)
    if name != "incrs_spmm_pipelined":
        np.testing.assert_allclose(out.numpy(), jout["incrs_spmm_reuse"],
                                   **TOL)


@pytest.mark.parametrize("m,bm", [(1, 128), (7, 128), (29, 8), (50, 16),
                                  (127, 128), (128, 128), (300, 128),
                                  (33, 3)])
def test_row_tile_rule_matches_jax(m, bm):
    assert tk._resolve_row_tile(m, bm) == jk._resolve_row_tile(m, bm)
    idx = torch.zeros((m, 2, 3), dtype=torch.int32)
    val = torch.ones((m, 2, 3))
    _, mp = tk._resolve_row_tile(m, bm)
    pi, pv = tk._pad_rows(idx, val, mp)
    ji, jv = jk._pad_rows(jnp.asarray(idx.numpy()), jnp.asarray(val.numpy()),
                          mp)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_grid_checks_raise():
    idx = torch.full((16, 2, 3), -1, dtype=torch.int32)
    val = torch.zeros((16, 2, 3))
    with pytest.raises(ValueError, match="not tileable"):
        tk.incrs_spmm(idx, val, torch.zeros(512, 100), bn=64)
    with pytest.raises(ValueError, match="InCRS stripes describe"):
        tk.incrs_spmm_reuse(idx, val, torch.zeros(500, 128))
    with pytest.raises(ValueError, match="share one device"):
        tk.incrs_spmm_pipelined(idx, val, torch.zeros(512, 128,
                                                      device="meta"))


@pytest.mark.parametrize("n,bn", [(1, 128), (96, 128), (130, 256),
                                  (512, 512), (640, 384), (1200, 512)])
def test_default_bn_rule(n, bn):
    assert tops.default_bn(n) == bn


@pytest.mark.parametrize("m,k,n", [(1, 300, 1), (50, 257, 96), (7, 31, 5),
                                   (40, 600, 130)])
@pytest.mark.parametrize("variant", ["auto", "expand", "reuse", "pipelined"])
def test_ops_spmm_pads_and_trims(m, k, n, variant):
    rng = np.random.default_rng(m + k + n)
    dense = _sparse(rng, m, k, 0.1)
    b = rng.normal(size=(k, n)).astype(np.float32)
    out = tops.spmm(TInCRS.from_dense(dense), b, variant=variant,
                    device="cpu")
    assert out.shape == (m, n) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), dense @ b, **TOL)
    if variant in ("auto", "expand") and (m, k, n) != (40, 600, 130):
        jout = np.asarray(jops.spmm(JInCRS.from_dense(dense),
                                    jnp.asarray(b), variant="expand"))
        np.testing.assert_allclose(out.numpy(), jout, **TOL)


def test_ops_spmm_on_prepared_operand_from_jax():
    dense = _operand("docword")
    j = JInCRS.from_dense(dense)
    ji, jv = jops.prep_sections(j, pad_rows_to=128)
    prep = convert.prepared_from_arrays(ji, jv, j.shape, j.section,
                                        device="cpu")
    b = np.random.default_rng(2).normal(size=(j.shape[1], 200)) \
        .astype(np.float32)
    out = tops.spmm(prep, torch.from_numpy(b), variant="reuse")
    np.testing.assert_allclose(out.numpy(), dense @ b, **TOL)
    with pytest.raises(ValueError, match="inner dims"):
        tops.spmm(prep, b[:-1])
    with pytest.raises(ValueError, match="variant"):
        tops.spmm(prep, b, variant="fastest")


def test_ops_spmm_other_formats_name_their_roadmap_item():
    from repro_torch.core.crs import CRS
    dense = _operand("k_ragged")
    with pytest.raises(TypeError, match="sparse x sparse"):
        tops.spmm(CRS.from_dense(dense), dense.T)     # ported: item 5
    out = tops.spmm(dense, dense.T, device="cpu")       # ported: item 7
    np.testing.assert_allclose(out.numpy(), dense @ dense.T, **TOL)
    from repro_torch.launch.mesh import make_mesh      # ported: item 8
    inc = TInCRS.from_dense(dense)
    sharded = tops.spmm(inc, dense.T, mesh=make_mesh(4, "cpu"))
    assert torch.equal(sharded, tops.spmm(inc, dense.T, device="cpu"))
    with pytest.raises(ValueError, match="InCRS data path"):
        tops.spmm(dense, dense.T, mesh=make_mesh(4, "cpu"), device="cpu")
    with pytest.raises(TypeError, match="BSR"):
        tops.spmm(object(), dense.T)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.serve.engine import SpMMEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inc = TInCRS.from_dense(_operand("k_ragged"))
    b = np.ones((300, 4), np.float32)
    for call in (lambda: tops.spmm(inc, b),
                 lambda: tops.prepare_incrs(inc),
                 lambda: tops.prep_sections(inc),
                 lambda: SpMMEngine(inc),
                 lambda: convert.prepared_from_arrays(
                     np.zeros((8, 1, 1), np.int32),
                     np.zeros((8, 1, 1), np.float32), (8, 256), 256)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert tops.spmm(inc, b, device="cpu").shape == (20, 4)


def test_decompress_oracle_matches_jax():
    dense = _operand("m_ragged")
    j = JInCRS.from_dense(dense, section=64, block=8)
    idx, val = (np.array(x) for x in jops.prep_sections(j, pad_rows_to=8))
    from repro.kernels import ref as jref
    want = np.asarray(jref.incrs_decompress(jnp.asarray(idx),
                                            jnp.asarray(val), 600, 64))
    got = tref.incrs_decompress(torch.from_numpy(idx), torch.from_numpy(val),
                                600, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:dense.shape[0]], dense)
