"""The port's GPipe pipeline (``repro_torch.train.pipeline``), the InCRS
stage stack (``sparse.stack_init``) and the compressed gradient sum
(``repro_torch.train.compress``) against the JAX package on the CPU.

JAX's ``pipeline_apply`` and ``compressed_psum`` run under ``shard_map``,
so one subprocess with 8 fake CPU devices writes their outputs (and a
JAX ``stack_init`` stack, and its stages applied one after another
through ``_spmm_incrs(variant="expand")``, never JAX ``auto``: ROADMAP
fault C1) to an ``.npz``; the port runs on a ``launch.mesh.Mesh`` of the
CPU named 4 (or 2) times. The JAX pipeline's stages are the stack's
dense weights (tanh(h @ W_i)), the port's the stack itself through the
InCRS stage function, so the two hold the schedule and the sparse
stages against each other. Tolerances: ``1e-5 * max|ref|`` (both sum in
f32, in another order); the compressed sum and its errors bit for bit.
"""
import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401

torch = pytest.importorskip("torch")

from repro_torch import convert                           # noqa: E402
from repro_torch.launch.mesh import Mesh, make_mesh       # noqa: E402
from repro_torch.sparse import api                        # noqa: E402
from repro_torch.sparse import linear as lin              # noqa: E402
from repro_torch.sparse import pattern as spat            # noqa: E402
from repro_torch.train import compress                    # noqa: E402
from repro_torch.train import pipeline as pp              # noqa: E402
from repro_torch.train import optimizer as topt           # noqa: E402
from repro_torch.train import trainer                     # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_TOL = 1e-5
N_STAGES, N_MICRO, MB, D = 4, 6, 5, 48

_JAX_REF = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.kernels import ops
from repro.sparse import api, linear as L
from repro.train.compress import compressed_psum, quantize_int8
from repro.train.pipeline import (pipeline_apply, shard_map, _SHARD_MAP_KW,
                                  split_stages)
out = {}
spec = api.SparseSpec("incrs", density=0.2, section=16, block=8)
stack = api.stack_init(jax.random.PRNGKey(0), N_STAGES, D, D, spec)
p = stack.inner
m = p.meta
out.update(values=np.asarray(p.values), fwd_idx=np.asarray(m.fwd_idx),
           bwd_idx=np.asarray(m.bwd_idx), t_gather=np.asarray(m.t_gather),
           mask=np.asarray(p.pattern.mask),
           meta=np.array([m.d_in, m.d_out, m.section, m.nnz, m.block]))
ws = np.stack([L.incrs_to_dense_weight(L.InCRSLinearParams(p.values[i], m))
               for i in range(N_STAGES)])
rng = np.random.default_rng(1)
x = rng.normal(size=(N_MICRO, MB, D)).astype(np.float32)
cot = rng.normal(size=(N_MICRO, MB, D)).astype(np.float32)
out.update(ws=ws, x=x, cot=cot)
mesh = Mesh(np.array(jax.devices()[:N_STAGES]), ("pipe",))
stage = lambda w, h: jnp.tanh(h @ w["w"])
run = lambda w, x_: pipeline_apply(stage, {"w": w}, x_, n_stages=N_STAGES,
                                   n_micro=N_MICRO, mesh=mesh)
out["pipe_out"] = np.asarray(run(jnp.asarray(ws), jnp.asarray(x)))
gw, gx = jax.grad(lambda w, x_: jnp.sum(run(w, x_) * cot),
                  argnums=(0, 1))(jnp.asarray(ws), jnp.asarray(x))
out.update(pipe_gw=np.asarray(gw), pipe_gx=np.asarray(gx))
seq = []
for mb in range(N_MICRO):
    h = jnp.asarray(x[mb])
    for i in range(N_STAGES):
        prep = ops.PreparedOperand(m.fwd_idx, p.values[i], (m.d_out, m.d_in),
                                   m.section)
        h = jnp.tanh(ops._spmm_incrs(prep, h.T, variant="expand",
                                     interpret=True).T)
    seq.append(np.asarray(h))
out["expand_out"] = np.stack(seq)
out["split"] = np.asarray(split_stages(
    {"a": jnp.arange(24.0).reshape(8, 3)}, 4)["a"])
# the compressed sum over a (pod 2, data 4) mesh, 5 steps of feedback
mesh2 = Mesh(np.array(jax.devices()).reshape(2, 4), ("pod", "data"))
def red(gl, el):
    r, ne = compressed_psum(gl[0], "pod", el[0])
    return r[None], ne[None]
f = shard_map(red, mesh=mesh2, in_specs=(P("pod"), P("pod")),
              out_specs=(P("pod"), P("pod")), **_SHARD_MAP_KW)
err = jnp.zeros((2, 256))
gs, rs, es = [], [], []
for s in range(5):
    g = jax.random.normal(jax.random.PRNGKey(s), (2, 256)) * (s + 1)
    r, err = f(g, err)
    gs.append(np.asarray(g)); rs.append(np.asarray(r)); es.append(
        np.asarray(err))
out.update(c_g=np.stack(gs), c_r=np.stack(rs), c_err=np.stack(es))
q, sc = quantize_int8(jnp.asarray(gs[2][0]))
out.update(q=np.asarray(q), q_scale=np.asarray(sc))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_pipeline") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = (f"N_STAGES, N_MICRO, MB, D = {N_STAGES}, {N_MICRO}, {MB}, {D}\n"
            + textwrap.dedent(_JAX_REF))
    proc = subprocess.run([sys.executable, "-c", code, str(path)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as z:
        return dict(z)


def _close(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=REF_TOL * scale)


def _stack_from_jax(jref):
    d_in, d_out, section, nnz, block = (int(v) for v in jref["meta"])
    fields = dict(fwd_idx=jref["fwd_idx"], bwd_idx=jref["bwd_idx"],
                  t_gather=jref["t_gather"], d_in=d_in, d_out=d_out,
                  section=section, nnz=nnz, block=block, mask=jref["mask"])
    return convert.linear_from_jax(jref["values"], fields, "incrs",
                                   device="cpu")


@pytest.fixture
def pipe_mesh():
    return make_mesh(N_STAGES, "cpu", axis="pipe")


# ----------------------------------------------------------------------
def test_a_jax_stack_carries_over(jref):
    stack = _stack_from_jax(jref)
    assert spat.is_stacked_node(stack.inner)
    assert not spat.is_lifecycle_node(stack.inner)
    assert tuple(stack.values.shape) == jref["values"].shape
    for i in range(N_STAGES):
        node = lin.InCRSLinearParams(stack.values[i], stack.meta)
        np.testing.assert_array_equal(lin.incrs_to_dense_weight(node),
                                      jref["ws"][i])


def test_pipeline_forward_matches_jax(jref, pipe_mesh):
    stack = _stack_from_jax(jref)
    x = torch.from_numpy(jref["x"])
    with torch.no_grad():
        out = pp.pipeline_apply(pp.incrs_stage_fn(), stack, x,
                                n_stages=N_STAGES, n_micro=N_MICRO,
                                mesh=pipe_mesh)
    _close(out.numpy(), jref["expand_out"])
    _close(out.numpy(), jref["pipe_out"])


def test_pipeline_forward_equals_stages_one_microbatch_at_a_time(
        jref, pipe_mesh):
    stack = _stack_from_jax(jref)
    x = torch.from_numpy(jref["x"])
    stage = pp.incrs_stage_fn()
    with torch.no_grad():
        out = pp.pipeline_apply(stage, stack, x, n_stages=N_STAGES,
                                n_micro=N_MICRO, mesh=pipe_mesh)
        for m in range(N_MICRO):
            h = x[m]
            for i in range(N_STAGES):
                h = stage(lin.InCRSLinearParams(stack.values[i], stack.meta),
                          h)
            assert torch.equal(out[m], h)


def test_pipeline_gradients_match_jax(jref, pipe_mesh):
    """Autograd through the schedule: each stage's value gradient
    (densified) against JAX's gradient of the dense stage weights on the
    live slots, pad slots exactly 0.0, and dx."""
    stack = _stack_from_jax(jref)
    x = torch.from_numpy(jref["x"].copy()).requires_grad_()
    out = pp.pipeline_apply(pp.incrs_stage_fn(), stack, x, n_stages=N_STAGES,
                            n_micro=N_MICRO, mesh=pipe_mesh)
    (out * torch.from_numpy(jref["cot"])).sum().backward()
    live = stack.meta.fwd_idx >= 0
    assert float(stack.values.grad[:, ~live].abs().max()) == 0.0
    mask = jref["mask"]
    for i in range(N_STAGES):
        g = lin.incrs_to_dense_weight(lin.InCRSLinearParams(
            stack.values.grad[i], stack.meta))
        _close(g[mask], jref["pipe_gw"][i][mask])
        assert not g[~mask].any()
    _close(x.grad.numpy(), jref["pipe_gx"])


def test_pipeline_counts_its_launches_on_the_stage_devices(jref, pipe_mesh,
                                                           monkeypatch):
    """Each (stage, microbatch) runs once forward (n_stages * n_micro
    InCRS products) and once backward for dx, in GPipe's order: time step
    t runs stage s on microbatch t - s."""
    stack = _stack_from_jax(jref)
    calls = []
    real = lin._incrs_product

    def spy(idx, values, shape, section, b):
        calls.append(idx is stack.meta.fwd_idx)
        return real(idx, values, shape, section, b)
    monkeypatch.setattr(lin, "_incrs_product", spy)
    order = []
    stage = pp.incrs_stage_fn()

    def traced(p, h):
        order.append(len(calls))
        return stage(p, h)
    x = torch.from_numpy(jref["x"].copy()).requires_grad_()
    out = pp.pipeline_apply(traced, stack, x, n_stages=N_STAGES,
                            n_micro=N_MICRO, mesh=pipe_mesh)
    n = N_STAGES * N_MICRO
    assert calls == [True] * n
    out.sum().backward()
    assert calls[n:] == [False] * n          # one dx launch a stage call
    assert len(order) == n


def test_pipeline_schedule_order():
    """The stage calls follow fill / steady / drain."""
    seen = []
    mesh = make_mesh(3, "cpu", axis="pipe")
    ws = torch.arange(3.0)

    def stage(w, h):
        seen.append(int(w))
        return h + w
    x = torch.zeros(4, 2)
    out = pp.pipeline_apply(stage, ws, x, n_stages=3, n_micro=4, mesh=mesh)
    assert torch.equal(out, torch.full((4, 2), 3.0))
    # t = 0: s0; t = 1: s1, s0; t = 2: s2, s1, s0; t = 3: s2, s1, s0;
    # t = 4: s2, s1; t = 5: s2
    assert seen == [0, 1, 0, 2, 1, 0, 2, 1, 0, 2, 1, 2]


def test_pipeline_and_stack_refusals(pipe_mesh):
    spec = api.SparseSpec("incrs", density=0.2, section=16, block=8)
    stack = api.stack_init(N_STAGES, 32, 32, spec,
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
    x = torch.zeros(N_MICRO, 2, 32)
    stage = pp.incrs_stage_fn()
    with pytest.raises(ValueError, match="3 stages need a mesh"):
        pp.pipeline_apply(stage, stack, x, n_stages=3, n_micro=N_MICRO,
                          mesh=pipe_mesh)
    with pytest.raises(ValueError, match="not n_micro=5"):
        pp.pipeline_apply(stage, stack, x, n_stages=N_STAGES, n_micro=5,
                          mesh=pipe_mesh)
    with pytest.raises(ValueError, match="pipe"):
        pp.pipeline_apply(stage, stack, x, n_stages=N_STAGES,
                          n_micro=N_MICRO, mesh=make_mesh(4, "cpu"))
    single = api.Linear.init(32, 32, spec,
                             generator=torch.Generator().manual_seed(0),
                             device="cpu")
    with pytest.raises(ValueError, match="must be a stack"):
        pp.pipeline_apply(stage, single, x, n_stages=N_STAGES,
                          n_micro=N_MICRO, mesh=pipe_mesh)
    with pytest.raises(ValueError, match="single-device InCRS"):
        api.stack_init(2, 32, 32, api.SparseSpec("bsr", density=0.5,
                                                 block=8),
                       generator=torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="single-device InCRS"):
        api.stack_init(2, 32, 32, api.SparseSpec(
            "incrs", density=0.5, mesh=make_mesh(2, "cpu")),
            generator=torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="needs density"):
        api.stack_init(2, 32, 32, api.SparseSpec("incrs"),
                       generator=torch.Generator(), device="cpu")


def test_stack_init_shares_one_pattern():
    spec = api.SparseSpec("incrs", density=0.25, section=16, block=8)
    stack = api.stack_init(3, 40, 56, spec,
                           generator=torch.Generator().manual_seed(4),
                           device="cpu")
    vals = stack.values.detach()
    live = stack.meta.fwd_idx >= 0
    assert vals.shape[0] == 3
    assert float(vals[:, ~live].abs().max()) == 0.0
    assert bool((vals[:, live] != 0).all())
    assert not torch.equal(vals[0], vals[1])
    first = api.Linear.init(40, 56, spec,
                            generator=torch.Generator().manual_seed(4),
                            device="cpu")
    assert torch.equal(first.values, vals[0])          # stage 0's draw
    assert stack.pattern.nnz == first.pattern.nnz


def test_prune_callback_skips_a_stack_with_a_warning():
    spec = api.SparseSpec("incrs", density=0.5, section=16, block=8)
    model = torch.nn.ModuleDict({
        "pipe": api.stack_init(2, 32, 32, spec,
                               generator=torch.Generator().manual_seed(0),
                               device="cpu"),
        "l1": api.Linear.init(32, 32, spec,
                              generator=torch.Generator().manual_seed(1),
                              device="cpu")})
    state = topt.adamw_init(topt.AdamWConfig(),
                            dict(model.named_parameters()))
    cb = trainer.make_prune_callback(spat.PruneSchedule(
        0.25, 4, warmup_frac=0.0, every=1))
    before = model["pipe"].values.detach().clone()
    with pytest.warns(UserWarning, match="stacked per-stage values"):
        info = cb(2, model, state)
    assert info["layers"] == 1                  # l1 only
    assert torch.equal(model["pipe"].values, before)
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # warned once only
        cb(3, model, state)


def test_split_stages_matches_jax(jref):
    got = pp.split_stages({"a": torch.arange(24.0).reshape(8, 3)}, 4)["a"]
    np.testing.assert_array_equal(got.numpy(), jref["split"])
    with pytest.raises(ValueError, match="do not divide"):
        pp.split_stages([torch.zeros(6, 2)], 4)


# ----------------------------------------------------------------------
def test_quantize_int8_matches_jax(jref):
    q, scale = compress.quantize_int8(torch.from_numpy(jref["c_g"][2][0]))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), jref["q"])
    assert float(scale) == float(jref["q_scale"])


def test_compressed_psum_matches_jax_bit_for_bit(jref):
    """Five steps of error feedback over 2 participants: the sum and each
    participant's error equal JAX's ``compressed_psum`` over its "pod"
    axis."""
    mesh = Mesh([torch.device("cpu")] * 2, ("pod",))
    errs = compress.init_error_feedback({"g0": torch.zeros(256),
                                         "g1": torch.zeros(256)})
    errs = [errs["g0"], errs["g1"]]
    acc_c, acc_e = torch.zeros(256), torch.zeros(256)
    for s in range(5):
        g = torch.from_numpy(jref["c_g"][s])
        total, errs = compress.compressed_psum([g[0], g[1]], errs,
                                               mesh=mesh)
        np.testing.assert_array_equal(total.numpy(), jref["c_r"][s][0])
        for i in range(2):
            np.testing.assert_array_equal(errs[i].numpy(),
                                          jref["c_err"][s][i])
        acc_c += total
        acc_e += g.sum(0)
    assert float((acc_c - acc_e).abs().max() / acc_e.abs().max()) < 0.02


def test_compressed_psum_tree_and_refusals():
    mesh = make_mesh(3, "cpu")
    gen = torch.Generator().manual_seed(0)
    trees = [{"a": torch.randn(5, generator=gen),
              "b": torch.randn(2, 3, generator=gen)} for _ in range(3)]
    errs = [compress.init_error_feedback(t) for t in trees]
    out, new = compress.compressed_psum_tree(trees, errs, mesh=mesh)
    for k in ("a", "b"):
        want, _ = compress.compressed_psum([t[k] for t in trees],
                                           [e[k] for e in errs], mesh=mesh)
        assert torch.equal(out[k], want)
        assert new[0][k].shape == trees[0][k].shape
    with pytest.raises(ValueError, match="2 tensors for a mesh of 3"):
        compress.compressed_psum([torch.zeros(2)] * 2, [torch.zeros(2)] * 2,
                                 mesh=mesh)
