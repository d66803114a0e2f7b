"""The port's row-sharded InCRS path against the JAX package, on the CPU.

The JAX sharded path runs under ``shard_map`` over a ``Mesh``; here it
runs in one subprocess with 8 fake CPU devices (the main process keeps
its single-device view, as ``tests/test_distributed.py`` does), which
writes its sharded stripes, its sharded pack and its sharded C (the
``expand`` order in interpret mode) to an ``.npz``. The port's path runs on
a mesh of the CPU named 8 times (``launch.mesh.make_mesh(8, "cpu")``), its
kernels' plain versions.

JAX's own sharded tests (``tests/test_distributed.py``) fail on this tree
with ROADMAP fault C1 (``auto`` reaches the pipelined Pallas kernel), so
the port's sharded VJP is held against the JAX pieces run shard by shard
with ``variant="expand"`` (dx's ``ops.spmm`` over each shard's transposed
stripes, summed in shard order, and ``_stripe_dw``), as
``test_torch_train.py`` holds the single-device VJP; and the three JAX
cases run on the port against the port's single-device path.

Tolerances: stripes, packs and the per-shard rows bit for bit; forward
and dW bitwise equal to the single-device path; dx bitwise where a shard
is whole sections, else rtol 1e-5 / atol 1e-6 (JAX's pins); against JAX's
products ``1e-5 * max|ref|`` (both sum in f32, in another order).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                   # noqa: E402

from repro.kernels import ops as jops                     # noqa: E402
from repro.sparse import linear as jlin                   # noqa: E402
from repro_torch import convert                           # noqa: E402
from repro_torch.core.incrs import InCRS as TInCRS        # noqa: E402
from repro_torch.kernels import ops                       # noqa: E402
from repro_torch.launch.mesh import Mesh, make_mesh       # noqa: E402
from repro_torch.models import sharding as sh             # noqa: E402
from repro_torch.serve import engine as teng              # noqa: E402
from repro_torch.serve import tenancy                     # noqa: E402
from repro_torch.sparse import api                        # noqa: E402
from repro_torch.sparse import linear as lin              # noqa: E402
from repro_torch.sparse import pattern as spat            # noqa: E402
from repro_torch.train import optimizer as opt            # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_TOL = 1e-5
SPEC1 = api.SparseSpec("incrs", section=64, block=8)
# (d_in, d_out): 8 shards of one section each, then of two
PACKS = {"aligned": (96, 512), "two_sections": (100, 1024)}

_JAX_REF = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core.incrs import InCRS
from repro.kernels import ops
from repro.sparse import linear as L
out = {}
mesh = Mesh(np.array(jax.devices()).reshape(8), ("data",))
rng = np.random.default_rng(0)
d = np.where(rng.random((96, 600)) < 0.05, rng.normal(size=(96, 600)),
             0.0).astype(np.float32)
b = rng.normal(size=(600, 48)).astype(np.float32)
inc = InCRS.from_dense(d)
p = ops.prepare_incrs_sharded(inc, mesh)
out.update(d=d, b=b, prep_idx=np.asarray(p.idx), prep_val=np.asarray(p.val),
           rows_per_shard=p.rows_per_shard)
out["c"] = np.asarray(ops._spmm_incrs_sharded(
    p, jnp.asarray(b), variant="expand", interpret=True))
mesh2 = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
p2 = ops.prepare_incrs_sharded(inc, mesh2, axis="model", pad_rows_to=8)
out.update(model_idx=np.asarray(p2.idx), model_val=np.asarray(p2.val),
           model_rows=p2.rows_per_shard)
for name, (d_in, d_out) in PACKS.items():
    w = np.where(rng.random((d_in, d_out)) < 0.1,
                 rng.normal(size=(d_in, d_out)), 0.0).astype(np.float32)
    ps = L._incrs_sharded_from_dense(w, mesh=mesh, section=64, block=8)
    m = ps.meta
    out.update({f"{name}_w": w, f"{name}_values": np.asarray(ps.values),
                f"{name}_fwd_idx": np.asarray(m.fwd_idx),
                f"{name}_bwd_idx": np.asarray(m.bwd_idx),
                f"{name}_t_gather": np.asarray(m.t_gather),
                f"{name}_meta": np.array([m.d_in, m.d_out, m.section, m.nnz,
                                          m.block, m.shard_width])})
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    """JAX's sharded stripes, pack and C, from 8 fake CPU devices."""
    path = tmp_path_factory.mktemp("jax_sharded") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = f"PACKS = {PACKS!r}\n" + textwrap.dedent(_JAX_REF)
    proc = subprocess.run([sys.executable, "-c", code, str(path)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as z:
        return dict(z)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, "cpu")


def _stacked(ts):
    return np.stack([t.detach().cpu().numpy() for t in ts])


def _sparse_w(rng, shape, density):
    return np.where(rng.random(shape) < density, rng.normal(size=shape),
                    0.0).astype(np.float32)


def _close(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=REF_TOL * scale)


# ----------------------------------------------------------------------
def test_mesh_and_axis_rules():
    m = Mesh(np.array([torch.device("cpu")] * 8, dtype=object).reshape(2, 4),
             ("data", "model"))
    assert m.shape == {"data": 2, "model": 4}
    assert ops.shard_axes(m, None) == (("data", "model"), 8)
    assert ops.shard_axes(m, "model") == (("model",), 4)
    assert len(ops.shard_devices(m, ("model",))) == 4
    with pytest.raises(ValueError, match="no \\['pod'\\]"):
        ops.shard_axes(m, "pod")
    with pytest.raises(ValueError, match="one type"):
        Mesh(["cpu", "meta"], ("data",))
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu", "cpu"], ("data", "model"))
    assert make_mesh(3, "cpu").device_list == (torch.device("cpu"),) * 3
    w = np.ones((64, 96), np.float32)
    # the active context gives the mesh, its incrs_shard rule the axes
    # (("data", "model") cut to the axes the mesh has)
    one = Mesh(["cpu"] * 4, ("model",))
    with sh.axis_rules(one):
        assert sh.current_mesh() is one and sh.rule_active("incrs_shard")
        assert sh.resolve(sh.INCRS_STRIPE_AXES) == (("model",), None,
                                                    None, None)
        p = lin._incrs_sharded_from_dense(w, section=32, block=8)
    assert p.meta.axes == ("model",) and p.meta.n_shards == 4
    assert sh.current_mesh() is None and not sh.rule_active("incrs_shard")
    with pytest.raises(ValueError, match="needs a mesh"):
        lin._incrs_sharded_from_dense(w, section=32, block=8)
    with pytest.raises(ValueError, match="divide into 5"):
        lin._incrs_sharded_from_dense(w, mesh=make_mesh(5, "cpu"),
                                      section=32, block=8)


def test_prepare_incrs_sharded_matches_jax(jref, mesh):
    inc = TInCRS.from_dense(jref["d"])
    p = ops.prepare_incrs_sharded(inc, mesh)
    np.testing.assert_array_equal(_stacked(p.idx), jref["prep_idx"])
    np.testing.assert_array_equal(_stacked(p.val), jref["prep_val"])
    assert p.rows_per_shard == int(jref["rows_per_shard"])
    assert p.n_shards == 8 and p.shape == inc.shape
    m2 = Mesh(np.array([torch.device("cpu")] * 8, dtype=object).reshape(
        2, 4), ("data", "model"))
    p2 = ops.prepare_incrs_sharded(inc, m2, axis="model", pad_rows_to=8)
    np.testing.assert_array_equal(_stacked(p2.idx), jref["model_idx"])
    np.testing.assert_array_equal(_stacked(p2.val), jref["model_val"])
    assert p2.rows_per_shard == int(jref["model_rows"])
    # memoized on a pattern lineage: a version bump misses
    pat = spat.SparsityPattern(jref["d"].T != 0)
    hit = ops.prepare_incrs_sharded(inc, mesh, pattern=pat)
    assert ops.prepare_incrs_sharded(inc, mesh, pattern=pat) is hit
    pat.version += 1
    assert ops.prepare_incrs_sharded(inc, mesh, pattern=pat) is not hit


def test_sharded_spmm_matches_jax(jref, mesh):
    inc = TInCRS.from_dense(jref["d"])
    b = jref["b"]
    single = ops.spmm(inc, b, device="cpu", variant="expand")
    for variant in ("expand", "reuse", "pipelined", "auto"):
        c = ops.spmm(inc, b, mesh=mesh, variant=variant)
        assert c.shape == (96, 48) and c.device.type == "cpu"
        assert torch.equal(c, single), variant
    _close(c.numpy(), jref["c"])
    prep = ops.prepare_incrs_sharded(inc, mesh)
    # each shard's rows are the single-device rows, bit for bit
    for s, part in enumerate(ops.sharded_panels(
            prep, {torch.device("cpu"): torch.from_numpy(b)})):
        lo, hi = prep.row_range(s)
        assert torch.equal(part, single[lo:hi])
    assert torch.equal(ops.spmm(prep, b), single)
    # a narrow panel clamps bm to itself: the same rows
    narrow = ops.prepare_incrs_sharded(inc, mesh, pad_rows_to=8)
    assert narrow.padded_rows == 16
    assert torch.equal(ops.spmm(narrow, b), single)


@pytest.mark.parametrize("name", sorted(PACKS))
def test_sharded_pack_matches_jax(jref, mesh, name):
    w = jref[f"{name}_w"]
    p = lin._incrs_sharded_from_dense(w, mesh=mesh, section=64, block=8)
    m = p.meta
    for field in ("fwd_idx", "bwd_idx", "t_gather"):
        np.testing.assert_array_equal(_stacked(getattr(m, field)),
                                      jref[f"{name}_{field}"], err_msg=field)
    np.testing.assert_array_equal(_stacked(p.values), jref[f"{name}_values"])
    assert [m.d_in, m.d_out, m.section, m.nnz, m.block, m.shard_width] == \
        jref[f"{name}_meta"].tolist()
    assert m.pattern.packed["incrs_sharded"] is m
    np.testing.assert_array_equal(lin.incrs_sharded_to_dense_weight(p), w)
    # the JAX layer carried across computes what the port's pack does
    meta = jref[f"{name}_meta"].tolist()
    got = convert.linear_from_jax(
        jref[f"{name}_values"],
        {"fwd_idx": jref[f"{name}_fwd_idx"],
         "bwd_idx": jref[f"{name}_bwd_idx"],
         "t_gather": jref[f"{name}_t_gather"],
         **dict(zip(("d_in", "d_out", "section", "nnz", "block",
                     "shard_width"), meta)),
         "axes": ["data"], "mask": w != 0},
        "incrs_sharded", mesh=mesh)
    assert got.format == "incrs_sharded" and got.nnz == m.nnz
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(8, w.shape[0])).astype(np.float32))
    assert torch.equal(got(x), api.apply(p, x))
    with pytest.raises(ValueError, match="needs mesh="):
        convert.linear_from_jax(jref[f"{name}_values"], {"axes": ["data"]},
                                "incrs_sharded")


@pytest.mark.parametrize("name", sorted(PACKS))
def test_sharded_vjp_matches_jax_pieces(jref, mesh, name):
    w = jref[f"{name}_w"]
    lyr = api.Linear.from_dense(w, dataclasses.replace(SPEC1, mesh=mesh))
    m = lyr.meta
    rng = np.random.default_rng(4)
    x64 = rng.normal(size=(16, w.shape[0]))
    x = torch.tensor(x64.astype(np.float32), requires_grad=True)
    y = lyr(x)
    dy = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(np.float32))
    y.backward(dy)
    sw, dyn = m.shard_width, dy.numpy()
    vals = jref[f"{name}_values"]
    ys, dx = [], None
    for s in range(m.n_shards):
        fi, bi = jref[f"{name}_fwd_idx"][s], jref[f"{name}_bwd_idx"][s]
        prep = jops.PreparedOperand(jnp.asarray(fi), jnp.asarray(vals[s]),
                                    (sw, m.d_in), m.section)
        ys.append(np.asarray(jops.spmm(prep, jnp.asarray(x64.T, jnp.float32),
                                       variant="expand")).T)
        flat = np.concatenate([vals[s].ravel(), [0.0]]).astype(np.float32)
        tvals = flat[jref[f"{name}_t_gather"][s]].reshape(bi.shape)
        tprep = jops.PreparedOperand(jnp.asarray(bi), jnp.asarray(tvals),
                                     (m.d_in, sw), m.section)
        part = np.asarray(jops.spmm(
            tprep, jnp.asarray(dyn[:, s * sw:(s + 1) * sw].T),
            variant="expand")).T
        dx = part if dx is None else dx + part
        dw = np.asarray(jlin._stripe_dw(jnp.asarray(fi), m.section,
                                        jnp.asarray(x.detach().numpy()),
                                        jnp.asarray(dyn[:, s * sw:
                                                        (s + 1) * sw])))
        _close(lyr.values[s].grad.numpy(), dw)
    _close(y.detach().numpy(), np.concatenate(ys, axis=1))
    _close(x.grad.numpy(), dx)
    # and against float64: dW on the live slots, dx
    wl = w.astype(np.float64)
    _close(x.grad.numpy(), dyn.astype(np.float64) @ wl.T)
    live = w != 0
    g64 = (x64.T @ dyn.astype(np.float64))
    _close(lyr.to_dense([v.grad for v in lyr.values])[live], g64[live])


# ----------------------------------------------------------------------
# tests/test_distributed.py's three sharded cases, on the port.
def _grads(layer, x):
    x = x.detach().clone().requires_grad_(True)
    (layer(x) ** 2).sum().backward()
    vals = layer.values
    g = vals.grad if isinstance(vals, torch.Tensor) else \
        [v.grad for v in vals]
    return layer.to_dense(g), x.grad


def test_sharded_incrs_linear_matches_single_device(mesh):
    spec8 = dataclasses.replace(SPEC1, mesh=mesh)
    rng = np.random.default_rng(0)
    for d in (0.0, 0.03, 0.5):
        w = _sparse_w(rng, (96, 512), d)
        l1 = api.Linear.from_dense(w, SPEC1, device="cpu")
        l8 = api.Linear.from_dense(w, spec8)
        assert l8.meta.n_shards == 8 and l8.meta.shard_width == 64
        assert len({v.device for v in l8.values}) == 1   # one CPU, 8 panels
        np.testing.assert_array_equal(l1.to_dense(), l8.to_dense())
        x = torch.from_numpy(rng.normal(size=(16, 96)).astype(np.float32))
        assert torch.equal(l1(x), l8(x))
        g1w, g1x = _grads(l1, x)
        g8w, g8x = _grads(l8, x)
        np.testing.assert_array_equal(g1w, g8w)
        assert torch.equal(g1x, g8x)           # shard_width == section
    # two sections a shard: dx reassociates the f32 sums
    w = _sparse_w(rng, (100, 1024), 0.1)
    l1 = api.Linear.from_dense(w, SPEC1, device="cpu")
    l8 = api.Linear.from_dense(w, spec8)
    x = torch.from_numpy(rng.normal(size=(8, 100)).astype(np.float32))
    assert torch.equal(l1(x), l8(x))
    g1w, g1x = _grads(l1, x)
    g8w, g8x = _grads(l8, x)
    np.testing.assert_array_equal(g1w, g8w)
    np.testing.assert_allclose(g8x.numpy(), g1x.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_spmm_engine_sharded_wave_roundtrip(mesh):
    rng = np.random.default_rng(0)
    d = _sparse_w(rng, (96, 600), 0.05)
    inc = TInCRS.from_dense(d)
    eng = teng.SpMMEngine(inc, mesh=mesh, max_wave_cols=128)
    assert eng.sharded and eng.prep.n_shards == 8
    assert eng.device == torch.device("cpu")
    reqs = [teng.SpMMRequest(i, rng.normal(size=(600, 48 + i))
                             .astype(np.float32)) for i in range(5)]
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert len(done) == 5 and all(r.done for r in done)
    assert eng.stats["waves"] >= 2
    single = ops.prepare_incrs(inc, device="cpu")
    for r in done:
        np.testing.assert_allclose(r.out, d @ r.b, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(
            r.out, ops.spmm(single, r.b).numpy())
    # a trained sharded layer's stripes serve as they are
    p = api.Linear.init(600, 96, dataclasses.replace(
        SPEC1, density=0.05, mesh=mesh),
        generator=torch.Generator().manual_seed(1)).inner
    eng2 = teng.SpMMEngine(p.prep)
    eng2.submit(teng.SpMMRequest(0, rng.normal(size=(600, 32))
                                 .astype(np.float32)))
    out = eng2.run()[0]
    np.testing.assert_allclose(
        out.out, lin.incrs_sharded_to_dense_weight(p).T @ out.b,
        rtol=1e-4, atol=1e-4)


def test_spmm_engine_sharded_swap_pattern(mesh):
    rng = np.random.default_rng(0)
    p = api.Linear.init(600, 96, dataclasses.replace(
        SPEC1, density=0.5, mesh=mesh),
        generator=torch.Generator().manual_seed(1)).inner
    eng = teng.SpMMEngine(p, max_wave_cols=128)
    assert eng.sharded and eng.pattern_version == 0

    def serve(rid):
        b = rng.normal(size=(600, 32)).astype(np.float32)
        eng.submit(teng.SpMMRequest(rid, b))
        return b, [r for r in eng.run() if r.rid == rid][0].out
    b, out = serve(0)
    np.testing.assert_allclose(
        out, lin.incrs_sharded_to_dense_weight(p).T @ b, rtol=1e-4,
        atol=1e-4)
    p2 = spat.magnitude_repack(p, 0.1)
    assert spat.get_pattern(p2).version == 1
    assert spat.get_pattern(p2).uid == spat.get_pattern(p).uid
    eng.swap_pattern(p2)
    assert eng.pattern_version == 1 and eng.stats["pattern_swaps"] == 1
    assert eng.prep.n_shards == 8
    b, out = serve(1)
    w2 = lin.incrs_sharded_to_dense_weight(p2)
    np.testing.assert_allclose(out, w2.T @ b, rtol=1e-4, atol=1e-4)
    w1 = lin.incrs_sharded_to_dense_weight(p)
    live = w2 != 0
    np.testing.assert_array_equal(w2[live], w1[live])
    # single-device and sharded operands replace each other
    single = ops.prepare_incrs(TInCRS.from_dense(w2.T), device="cpu")
    eng.swap_pattern(single)
    assert not eng.sharded
    b, out = serve(2)
    np.testing.assert_allclose(out, w2.T @ b, rtol=1e-4, atol=1e-4)
    eng.swap_pattern(TInCRS.from_dense(w1.T), mesh=mesh)
    assert eng.sharded
    b, out = serve(3)
    np.testing.assert_allclose(out, w1.T @ b, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(96, 512), (100, 768)],
                         ids=["whole_sections", "from_dense"])
def test_shard_of_a_trained_layer(mesh, shape):
    """``Linear.shard`` keeps values and lineage; where a shard is whole
    sections it cuts the packed stripes, bit for bit the from-dense pack
    of the same weight and pattern."""
    rng = np.random.default_rng(5)
    w = _sparse_w(rng, shape, 0.2)
    l1 = api.Linear.from_dense(w, SPEC1, device="cpu")
    with torch.no_grad():                 # a trained value of exactly 0.0
        l1.values.view(-1)[torch.nonzero(
            l1.meta.fwd_idx.view(-1) >= 0)[0]] = 0.0
    ls = l1.shard(mesh)
    assert ls.pattern is l1.pattern and ls.nnz == l1.nnz
    assert l1.pattern.packed["incrs_sharded"] is ls.meta
    want = lin._incrs_sharded_from_dense(l1.to_dense(), mesh=mesh,
                                         section=64, block=8,
                                         _pattern=l1.pattern)
    for field in ("fwd_idx", "bwd_idx", "t_gather"):
        np.testing.assert_array_equal(_stacked(getattr(ls.meta, field)),
                                      _stacked(getattr(want.meta, field)))
    np.testing.assert_array_equal(_stacked(ls.values), _stacked(want.values))
    assert ls.spec.sharded and ls.spec.shard_axis == ("data",)
    np.testing.assert_array_equal(ls.to_dense(), l1.to_dense())
    x = torch.from_numpy(rng.normal(size=(4, shape[0])).astype(np.float32))
    assert torch.equal(ls(x), l1(x))
    with pytest.raises(ValueError, match="re-shards the single-device"):
        ls.shard(mesh)


def test_sharded_lifecycle_and_adamw(mesh):
    """repack / magnitude_repack / repack_onto on a sharded layer, and two
    AdamW steps: the moments and values stay on the pattern, pad slots
    0.0, and the steps follow the single-device layer's."""
    rng = np.random.default_rng(6)
    w = _sparse_w(rng, (96, 512), 0.3)
    spec8 = dataclasses.replace(SPEC1, mesh=mesh)
    l1 = api.Linear.from_dense(w, SPEC1, device="cpu")
    l8 = api.Linear.from_dense(w, spec8)
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                          grad_clip=1e9)
    x = torch.from_numpy(rng.normal(size=(16, 96)).astype(np.float32))
    states = {}
    for name, layer in (("one", l1), ("eight", l8)):
        params = dict(layer.named_parameters())
        state = opt.adamw_init(cfg, params)
        for _ in range(2):
            layer.zero_grad()
            (layer(x) ** 2).sum().backward()
            grads = {k: p.grad for k, p in params.items()}
            _, state, _ = opt.adamw_update(cfg, grads, state, params)
        states[name] = state
    assert sorted(dict(l8.named_parameters())) == \
        [f"values.{s}" for s in range(8)]
    np.testing.assert_allclose(l8.to_dense(), l1.to_dense(), rtol=1e-6,
                               atol=1e-7)
    for s in range(8):
        pads = l8.values[s].detach()[l8.meta.fwd_idx[s] < 0]
        assert float(pads.abs().max()) == 0.0
    node = l8.inner
    new = spat.magnitude_repack(node, 0.1)
    assert type(new) is lin.ShardedInCRSLinearParams
    assert new.meta.n_shards == 8 and new.meta.mesh is mesh
    m = dataclasses.replace(node, values=tuple(
        states["eight"]["m"][f"values.{s}"] for s in range(8)))
    moved = spat.repack_onto(m, new)
    assert all(v.device == d for v, d in zip(moved.values, new.meta.devices))
    live = lin.incrs_sharded_to_dense_weight(new) != 0
    np.testing.assert_array_equal(
        lin.incrs_sharded_to_dense_weight(moved)[live],
        lin.incrs_sharded_to_dense_weight(m)[live])
    assert not spat.is_stacked_node(node) and spat.is_lifecycle_node(node)
    l8.set_inner(new)
    assert l8.pattern.version == 1 and l8.nnz == new.nnz
    same = spat.repack(new, spat.get_pattern(new).mask)
    np.testing.assert_array_equal(lin.incrs_sharded_to_dense_weight(same),
                                  lin.incrs_sharded_to_dense_weight(new))


def test_sharded_plan(mesh):
    rng = np.random.default_rng(7)
    w = _sparse_w(rng, (64, 128), 0.2)
    b = rng.normal(size=(64, 40)).astype(np.float32)
    spec = api.SparseSpec("incrs", mask=w != 0, section=32, block=8)
    p = api.plan(spec, (64, 40), mesh=make_mesh(4, "cpu"), tune="off")
    assert p.spec.sharded and p.meta.n_shards == 4
    assert p.shape == (128, 64)
    idx, section = p._tuning_arrays()
    assert tuple(idx.shape) == tuple(p.meta.fwd_idx[0].shape)
    bound = p.bind(p.pack(w))
    assert len(bound.values) == 4 and bound.device == torch.device("cpu")
    want = api.plan(spec, (64, 40), tune="off")
    np.testing.assert_array_equal(
        bound(b).numpy(),
        want.bind(want.pack(w), device="cpu")(b).numpy())
    np.testing.assert_allclose(bound(b).numpy(), w.T @ b, rtol=1e-4,
                               atol=1e-4)
    served = api.plan_for_operand(w.T, dataclasses.replace(
        api.SparseSpec("incrs", section=32, block=8), mesh=mesh))
    assert served.plan.spec.sharded
    eng = teng.SpMMEngine(served, max_wave_cols=64)
    eng.submit(teng.SpMMRequest(0, b))
    np.testing.assert_array_equal(eng.run()[0].out, bound(b).numpy())
    tuned = api.plan(spec, (64, 40), mesh=mesh, tune="off")
    assert tuned.lookup_tuned(40) is None


def test_operand_bytes_of_a_sharded_operand(mesh):
    rng = np.random.default_rng(8)
    d = _sparse_w(rng, (96, 600), 0.05)
    prep = ops.prepare_incrs_sharded(TInCRS.from_dense(d), mesh)
    want = sum(t.numel() * 4 for t in (*prep.idx, *prep.val))
    assert tenancy.operand_bytes(prep) == want
    lyr = api.Linear.from_dense(d.T, dataclasses.replace(
        SPEC1, mesh=mesh, density=None))
    bound = lyr.bound()
    got = tenancy.operand_bytes(bound)
    vals = sum(v.numel() * 4 for v in bound.values)
    idx = sum(t.numel() * 4 for t in lyr.meta.fwd_idx)
    assert got == vals + idx
    pool = tenancy.TenantPool(hbm_budget_bytes=10 * want)
    pool.add("sharded", TInCRS.from_dense(d), mesh=mesh, max_wave_cols=128)
    pool.submit("sharded", teng.SpMMRequest(0, rng.normal(
        size=(600, 16)).astype(np.float32)))
    out = pool.run()[0]
    np.testing.assert_allclose(out.out, d @ out.b, rtol=1e-4, atol=1e-4)
    assert pool.resident_bytes() == want
    assert pool.engine("sharded").sharded


def test_sharded_refusals(mesh):
    rng = np.random.default_rng(9)
    d = _sparse_w(rng, (96, 600), 0.05)
    inc = TInCRS.from_dense(d)
    b = np.ones((600, 4), np.float32)
    with pytest.raises(ValueError, match="mesh sharding is the InCRS"):
        api.SparseSpec("bsr", block=8, mesh=mesh)
    with pytest.raises(ValueError, match="re-shard"):
        ops.spmm(ops.prepare_incrs(inc, device="cpu"), b, mesh=mesh)
    with pytest.raises(ValueError, match="re-shard"):
        teng.SpMMEngine(ops.prepare_incrs(inc, device="cpu"), mesh=mesh)
    sharded = ops.prepare_incrs_sharded(inc, mesh)
    other = make_mesh(8, "cpu")
    with pytest.raises(ValueError, match="bound to"):
        teng.SpMMEngine(sharded, mesh=other)
    with pytest.raises(ValueError, match="bound to its own mesh"):
        ops.spmm(sharded, b, mesh=other)
    bound = api.plan_for_operand(d, api.SparseSpec("incrs"), device="cpu")
    with pytest.raises(ValueError, match="committed to its layout"):
        teng.SpMMEngine(bound, mesh=mesh)
    with pytest.raises(ValueError, match="inner dims"):
        ops.spmm(sharded, b[:-1])
    eng = teng.SpMMEngine(sharded, max_wave_cols=128)
    with pytest.raises(ValueError, match="shape"):
        eng.swap_pattern(TInCRS.from_dense(d[:, :300]), mesh=mesh)
    assert eng.prep is sharded               # a refused swap keeps serving
    with pytest.raises(ValueError, match="row-sharded spmm needs mesh="):
        ops._spmm_incrs_sharded(inc, b)


def test_launcher_shards_on_cpu(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--spmm", "--spmm-shards", "4", "--device", "cpu",
                     "--n-requests", "3", "--spmm-swap"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "4-way row-sharded over ['cpu']" in out and "swaps=1" in out
    with pytest.raises(SystemExit, match="does not shard"):
        serve.main(["--spmm", "--spmm-shards", "4", "--device", "cpu",
                    "--format", "bsr"])
