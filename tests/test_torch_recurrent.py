"""The port's recurrent mixers and the paper's host-side models against the
JAX package on the CPU.

Part A: ``_causal_conv``, ``SSD`` and ``RGLRU`` against ``layers.ssd`` and
``layers.rglru`` in train, prefill and decode mode (decode chained from the
prefill cache; S a multiple of the chunk, not a multiple and shorter than
it; a zero and a nonzero initial state; the caches' dtypes), the doubling
scan against a float64 sequential loop, the gradients, the route around
the reference's non-finite gradients at a chunk of 256 (ROADMAP queue 3,
C5), both recurrent models' init kinds, remat, served waves and a
checkpoint. Part B: the paper's host-side models (``core.crs``,
``core.incrs``, ``core.spmm``, ``core.cache_sim`` and the latency half of
``core.mesh_sim``) bit for bit against JAX's on seeded operands.

Inputs are made with numpy from a seed and handed to both packages; the
smoke configs compute in f32. The mixers' leaves are drawn by
``_recurrent_draw`` (matrices at 1/sqrt(fan_in), a step's decay about
0.9-0.99), so that the state carries the output; one SSD case has
``d_skip`` = 0, so that it carries all of it. Tolerances: layers and
logits rtol = atol = 1e-4 and, for a mixer's output, state and conv tail,
also 1e-4 of the tensor's own max|want|; gradients 1e-4 of each tensor's
max|g|; the scan against float64 1e-5 of max|h|; Part B bitwise (equal
counts, traces, statistics and cycles).
"""
import dataclasses

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401

torch = pytest.importorskip("torch")

import jax                                                # noqa: E402
import jax.numpy as jnp                                   # noqa: E402
from _recurrent_draw import MIXER_LEAVES, draw_mixer_leaf # noqa: E402

from repro import configs as jconfigs                     # noqa: E402
from repro.core import cache_sim as jcache                # noqa: E402
from repro.core import crs as jcrs                        # noqa: E402
from repro.core import incrs as jincrs                    # noqa: E402
from repro.core import mesh_sim as jmesh                  # noqa: E402
from repro.core import spmm as jspmm                      # noqa: E402
from repro.models import layers as jlayers                # noqa: E402
from repro.models import model as jmodel                  # noqa: E402
from repro.serve import engine as jeng                    # noqa: E402
from repro_torch import configs as tconfigs               # noqa: E402
from repro_torch import convert                           # noqa: E402
from repro_torch.checkpoint import CheckpointManager      # noqa: E402
from repro_torch.core import cache_sim as tcache          # noqa: E402
from repro_torch.core import crs as tcrs                  # noqa: E402
from repro_torch.core import incrs as tincrs              # noqa: E402
from repro_torch.core import mesh_sim as tmesh            # noqa: E402
from repro_torch.core import spmm as tspmm                # noqa: E402
from repro_torch.models import layers as tlayers          # noqa: E402
from repro_torch.models import model as tmodel            # noqa: E402
from repro_torch.serve import engine as teng              # noqa: E402
from repro_torch.train import optimizer as topt           # noqa: E402
from repro_torch.train import trainer as ttrainer         # noqa: E402

TOL = 1e-4
GRAD_TOL = 1e-4
SCAN_TOL = 1e-5
RECURRENT = ("mamba2-370m", "recurrentgemma-2b")
MIXERS = {"ssd": ("mamba2-370m", jlayers.init_ssd, jlayers.ssd,
                  tlayers.SSD, jlayers.init_ssd_cache,
                  tlayers.init_ssd_cache),
          "rglru": ("recurrentgemma-2b", jlayers.init_rglru, jlayers.rglru,
                    tlayers.RGLRU, jlayers.init_rglru_cache,
                    tlayers.init_rglru_cache)}


def _as_dict(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _close_by_tensor(got, want, tol=GRAD_TOL):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


# ----------------------------------------------------------------------
# shapes (the configs themselves: tests/test_torch_lm.py)
@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_shapes_and_applicable_equal_jax(name):
    """``SHAPES`` and ``applicable`` for every (architecture, shape) pair,
    full and smoke; ``long_500k`` applies to both recurrent archs."""
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for get in ("get", "get_smoke"):
        t, j = getattr(tconfigs, get)(name), getattr(jconfigs, get)(name)
        for shape in jconfigs.SHAPES:
            assert tconfigs.applicable(t, tconfigs.SHAPES[shape]) == \
                jconfigs.applicable(j, jconfigs.SHAPES[shape])
    if name in RECURRENT:
        assert tconfigs.applicable(tconfigs.get(name),
                                   tconfigs.SHAPES["long_500k"])[0]


# ----------------------------------------------------------------------
# the causal conv
@pytest.mark.parametrize("with_cache", [False, True],
                         ids=["zeros", "cache"])
@pytest.mark.parametrize("s", [1, 2, 3, 5, 40])
def test_causal_conv_matches_jax(s, with_cache):
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    c = rng.normal(size=(2, 3, 6)).astype(np.float32) if with_cache \
        else None
    jy, jc = jlayers._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                  None if c is None else jnp.asarray(c))
    ty, tc = tlayers._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                  None if c is None else torch.from_numpy(c))
    _close(ty, jy)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.shape == (2, 3, 6)


# ----------------------------------------------------------------------
# the mixers, layer by layer
def _mixer_pair(kind, seed=0, d_skip=None, **over):
    """(JAX cfg, JAX params, port layer) of one mixer on the same weights,
    every leaf drawn by ``draw_mixer_leaf`` (``d_skip``: its constant)."""
    arch, jinit, _, tcls, _, _ = MIXERS[kind]
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), **over)
    b = jlayers.Builder(jax.random.PRNGKey(seed), jnp.float32)
    jinit(b, jcfg)
    rng = np.random.default_rng(seed + 100)
    params = {k: draw_mixer_leaf(k, np.shape(v), rng, d_skip=d_skip)
              for k, v in b.params.items()}
    layer = tcls(tcfg, device="cpu")
    layer.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in
                           params.items()})
    return jcfg, {k: jnp.asarray(v) for k, v in params.items()}, layer


def _close_mixer(got, want):
    """rtol = atol = TOL, and within TOL of the tensor's own max|want|
    (a value far below 1 would pass the first alone)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    _close(got, want)
    _close_by_tensor(got, want, TOL)


def _random_cache(kind, cfg, rng, zero):
    _, _, _, _, jinit_cache, _ = MIXERS[kind]
    shapes = {k: v.shape for k, v in
              jinit_cache(cfg, 2, jnp.float32).items() if k != "end"}
    return {k: (np.zeros(s, np.float32) if zero else
                rng.normal(scale=0.5, size=s).astype(np.float32))
            for k, s in shapes.items()}


def _jcache(c, end=0):
    return {**{k: jnp.asarray(v) for k, v in c.items()},
            "end": jnp.asarray(end, jnp.int32)}


def _tcache(c, end=0):
    return {**{k: torch.from_numpy(v.copy()) for k, v in c.items()},
            "end": end}


def _every_mode(kind, s, init, d_skip=None):
    """Train mode; prefill from a zero or a nonzero cache (state and conv
    tail), its returned cache; then 4 decode steps chained from it, each
    output and cache held by ``_close_mixer``."""
    jcfg, jp, layer = _mixer_pair(kind, d_skip=d_skip)
    jfn = MIXERS[kind][2]
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    with torch.no_grad():
        got, none = layer(torch.from_numpy(x), mode="train")
    want, _ = jfn(jp, jcfg, jnp.asarray(x), mode="train")
    _close_mixer(got, want)
    assert none is None

    c0 = _random_cache(kind, jcfg, rng, zero=init == "zero")
    want, jc = jfn(jp, jcfg, jnp.asarray(x), mode="prefill",
                   cache=_jcache(c0))
    with torch.no_grad():
        got, tc = layer(torch.from_numpy(x), mode="prefill",
                        cache=_tcache(c0))
    _close_mixer(got, want)
    assert tc["end"] == int(jc["end"]) == s
    for k in ("conv", "state"):
        _close_mixer(tc[k], jc[k])
    for step in range(4):
        x1 = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        want, jc = jfn(jp, jcfg, jnp.asarray(x1), mode="decode", cache=jc)
        with torch.no_grad():
            got, tc = layer(torch.from_numpy(x1), mode="decode", cache=tc)
        _close_mixer(got, want)
        for k in ("conv", "state"):
            _close_mixer(tc[k], jc[k])
        assert tc["end"] == int(jc["end"]) == s + step + 1


@pytest.mark.parametrize("init", ["zero", "state"])
@pytest.mark.parametrize("s", [32, 40, 7],
                         ids=["chunks", "ragged", "short"])
@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_matches_jax_in_every_mode(kind, s, init):
    """``_every_mode``. The SSD smoke's chunk is 16: S = 32 is two chunks,
    40 pads the third, 7 is shorter than one."""
    _every_mode(kind, s, init)


@pytest.mark.parametrize("init", ["zero", "state"])
@pytest.mark.parametrize("s", [32, 40, 7],
                         ids=["chunks", "ragged", "short"])
def test_ssd_state_alone_carries_the_output(s, init):
    """``_every_mode`` for the SSD with ``d_skip`` = 0: the output is the
    state's read-out alone, in every mode."""
    _every_mode("ssd", s, init, d_skip=0.0)


@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_decode_refuses_like_jax(kind):
    jcfg, jp, layer = _mixer_pair(kind)
    x = torch.zeros(2, 2, jcfg.d_model)
    cache = MIXERS[kind][5](jcfg, 2, torch.float32, "cpu")
    for c, xx in ((None, x[:, :1]), (cache, x)):
        with pytest.raises(ValueError, match="single-token step"):
            layer(xx, mode="decode", cache=c)
        with pytest.raises(ValueError, match="single-token step"):
            MIXERS[kind][2](jp, jcfg, jnp.asarray(xx.numpy()),
                            mode="decode",
                            cache=None if c is None else jax.tree.map(
                                jnp.asarray, {k: np.asarray(v) for k, v in
                                              c.items()}))


@pytest.mark.parametrize("compute,cache_dt", [("float32", "bfloat16"),
                                              ("bfloat16", "float32")])
@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_cache_dtypes_match_jax(kind, compute, cache_dt):
    """After prefill the cache holds the state and conv tail in the
    compute dtype, whatever the cache was allocated in; decode keeps the
    state in the cache's dtype and the conv tail in the compute dtype,
    as JAX does."""
    jcfg, jp, layer = _mixer_pair(kind, dtype=compute)
    _, _, jfn, _, jinit_cache, tinit_cache = MIXERS[kind]
    cdt = getattr(jnp, compute)
    jc = jinit_cache(jcfg, 2, getattr(jnp, cache_dt))
    tc = tinit_cache(layer.cfg, 2, getattr(torch, cache_dt), "cpu")
    assert {k: _dtype_name(v) for k, v in tc.items() if k != "end"} == \
        {k: str(v.dtype) for k, v in jc.items() if k != "end"}
    x = np.random.default_rng(3).normal(size=(2, 5, jcfg.d_model))
    jx = jnp.asarray(x, cdt)
    tx = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, compute))
    with torch.no_grad():
        for mode, xs in (("prefill", slice(0, 4)), ("decode", slice(4, 5))):
            _, jc = jfn(jp, jcfg, jx[:, xs], mode=mode, cache=jc)
            _, tc = layer(tx[:, xs], mode=mode, cache=tc)
            assert {k: _dtype_name(v) for k, v in tc.items()
                    if k != "end"} == {k: str(v.dtype) for k, v in
                                       jc.items() if k != "end"}, mode
    assert tc["state"].dtype == getattr(torch, compute)


@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_grads_match_jax(kind):
    """Grads of sum(y^2) over every parameter and the input, at chunk 16
    for the SSD (S = 40: two full chunks and a padded one)."""
    jcfg, jp, layer = _mixer_pair(kind)
    jfn = MIXERS[kind][2]
    x = np.random.default_rng(9).normal(size=(2, 40, jcfg.d_model)).astype(
        np.float32)

    def jloss(p, xx):
        y, _ = jfn(p, jcfg, xx, mode="train")
        return jnp.sum(y * y)
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, _ = layer(tx, mode="train")
    (y * y).sum().backward()
    for k, p in layer.named_parameters():
        _close_by_tensor(p.grad.numpy(), np.asarray(jg[k]))
    _close_by_tensor(tx.grad.numpy(), np.asarray(jgx))


def _c5_case(chunk):
    """The SSD at mamba2's smoke widths with JAX's init (dt_bias = a_log =
    0, so dt ~ softplus(0) ~ 0.69 a step) on (1, 256, 64) inputs."""
    jcfg = dataclasses.replace(jconfigs.get_smoke("mamba2-370m"),
                               ssm_chunk=chunk)
    tcfg = dataclasses.replace(tconfigs.get_smoke("mamba2-370m"),
                               ssm_chunk=chunk)
    b = jlayers.Builder(jax.random.PRNGKey(0), jnp.float32)
    jlayers.init_ssd(b, jcfg)
    layer = tlayers.SSD(tcfg, device="cpu")
    layer.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in b.params.items()})
    x = np.random.default_rng(5).normal(size=(1, 256, 64)).astype(
        np.float32)
    return jcfg, b.params, layer, x


def _jax_ssd_grads(jcfg, params, x):
    def loss(p):
        y, _ = jlayers.ssd(p, jcfg, jnp.asarray(x), mode="train")
        return jnp.sum(y * y)
    return {k: np.asarray(v) for k, v in jax.grad(loss)(params).items()}


def _port_ssd_grads(layer, x):
    layer.zero_grad()
    y, _ = layer(torch.from_numpy(x), mode="train")
    (y * y).sum().backward()
    return {k: p.grad.numpy() for k, p in layer.named_parameters()}


def test_c5_port_grads_equal_jax_at_chunk_16():
    """Where JAX's gradients are finite (chunk 16, S = 256: 16 chunks) the
    port's equal them: masking inside the exponent changes no value."""
    jcfg, params, layer, x = _c5_case(16)
    want = _jax_ssd_grads(jcfg, params, x)
    got = _port_ssd_grads(layer, x)
    assert all(np.isfinite(v).all() for v in want.values())
    for k, g in got.items():
        _close_by_tensor(g, want[k])


def test_c5_port_grads_finite_at_chunk_256():
    """mamba2-370m's published chunk: every port gradient is finite and
    nonzero, and the forward equals JAX's (whose forward is right)."""
    jcfg, params, layer, x = _c5_case(256)
    got = _port_ssd_grads(layer, x)
    for k, g in got.items():
        assert np.isfinite(g).all() and np.abs(g).max() > 0, k
    with torch.no_grad():
        y, _ = layer(torch.from_numpy(x), mode="train")
    _close(y, jlayers.ssd(params, jcfg, jnp.asarray(x), mode="train")[0])


def test_c5_jax_grads_not_finite_at_chunk_256():
    """The departure from the reference, stated: JAX's
    ``where(tri, exp(li), 0)`` overflows to inf in the upper triangle (li
    reaches ~177 over 255 steps of ~0.69; exp overflows f32 above 88.7),
    the where's zero cotangent meets it, and 0 * inf is NaN in the grads
    of ``a_log``, ``dt_bias`` and ``w_dt``. The port's (previous test)
    are finite."""
    jcfg, params, _, x = _c5_case(256)
    want = _jax_ssd_grads(jcfg, params, x)
    bad = sorted(k for k, v in want.items() if not np.isfinite(v).all())
    assert bad == ["a_log", "dt_bias", "w_dt"]


# ----------------------------------------------------------------------
# the doubling scan
@pytest.mark.parametrize("s", [1, 7, 300, 1000])
def test_linear_scan_matches_a_float64_loop(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, size=(2, s, 5)).astype(np.float32)
    b = rng.normal(size=(2, s, 5)).astype(np.float32)
    want = np.zeros((2, s, 5))
    h = np.zeros((2, 5))
    for t in range(s):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        want[:, t] = h
    got = tlayers.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=SCAN_TOL * np.abs(want).max())


def test_linear_scan_takes_log2_steps_and_differentiates(monkeypatch):
    """ceil(log2 S) = 9 combining steps at S = 300 (b combined 9 times, a
    8: the last step needs no a), and autograd through it against a
    float64 loop's grads."""
    calls = []
    real = torch.cat

    def spy(ts, dim=0):
        calls.append(dim)
        return real(ts, dim=dim)
    a = torch.rand(1, 300, 3, dtype=torch.float64) * 0.5 + 0.5
    b = torch.randn(1, 300, 3, dtype=torch.float64)
    monkeypatch.setattr(torch, "cat", spy)
    tlayers.linear_scan(a, b)
    monkeypatch.undo()
    assert len(calls) == 9 + 8
    a.requires_grad_(True)
    b.requires_grad_(True)
    ga, gb = torch.autograd.grad(tlayers.linear_scan(a, b).square().sum(),
                                 (a, b))

    def loop(a, b):
        h, out = torch.zeros(1, 3, dtype=a.dtype), []
        for t in range(a.shape[1]):
            h = a[:, t] * h + b[:, t]
            out.append(h)
        return torch.stack(out, 1)
    la, lb = torch.autograd.grad(loop(a, b).square().sum(), (a, b))
    assert torch.allclose(ga, la, rtol=1e-10, atol=1e-10)
    assert torch.allclose(gb, lb, rtol=1e-10, atol=1e-10)


# ----------------------------------------------------------------------
# both models
def _model_pair(name, seed=0, **over):
    jcfg = dataclasses.replace(jconfigs.get_smoke(name), **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke(name), **over)
    params, _ = jmodel.init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 50)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.asarray(draw_mixer_leaf(path[-1].key, v.shape,
                                                    rng), v.dtype)
        if path[-1].key in MIXER_LEAVES else v, params)
    return jcfg, params, convert.model_from_jax(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("name", RECURRENT)
def test_init_kinds_match_jax_builder(name):
    """``model.init`` draws each parameter by its JAX init kind: ones,
    zeros or normal(0, 0.02), parameter for parameter."""
    cfg = tconfigs.get_smoke(name)
    params, _ = jmodel.init(jconfigs.get_smoke(name), jax.random.PRNGKey(0))
    want = _by_name(cfg, params)
    got = dict(tmodel.init(cfg, seed=0, device="cpu").named_parameters())
    assert set(got) == set(want)

    def kind(v):
        v = np.asarray(v, np.float64)
        if (v == 0).all():
            return "zeros"
        if (v == 1).all():
            return "ones"
        return "normal"
    kinds = {}
    for k, v in want.items():
        kinds[k] = kind(v)
        assert kind(got[k].detach().numpy()) == kinds[k], k
        if kinds[k] == "normal":
            assert 0.01 < float(got[k].detach().std()) < 0.03, k
    assert {k.rsplit(".", 1)[-1] for k, v in kinds.items()
            if v == "ones"} == ({"d_skip"} if name == "mamba2-370m"
                                else set())


def _by_name(cfg, tree):
    out = {"embed": tree["embed"], "norm_final": tree["norm_final"]}
    if not cfg.tie_embeddings:
        out["unembed"] = tree["unembed"]
    period = len(cfg.block_pattern)
    for i, kind in enumerate(cfg.block_pattern):
        blk = tree["groups"][f"block{i}_{kind}"]
        for g in range(cfg.n_groups):
            pre = f"blocks.{g * period + i}."
            for name, leaf in blk.items():
                if isinstance(leaf, dict):
                    for sub, arr in leaf.items():
                        out[f"{pre}{name}.{sub}"] = np.asarray(arr[g])
                else:
                    out[f"{pre}{name}"] = np.asarray(leaf[g])
    return out


@pytest.mark.parametrize("name", RECURRENT)
def test_model_from_jax_maps_the_mixer_leaves(name):
    """Every JAX leaf (``mixer/w_x``, ``mixer/a_param``, ...) lands on the
    port parameter of its name, value for value."""
    jcfg, params, model = _model_pair(name)
    want = _by_name(jcfg, params)
    got = {k: v.detach().numpy() for k, v in model.named_parameters()}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
    kinds = {type(b.mixer).__name__ for b in model.blocks}
    assert kinds == ({"SSD"} if name == "mamba2-370m"
                     else {"RGLRU", "Attention"})


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("name", RECURRENT)
def test_remat_changes_no_value(name, policy):
    """Loss and grads bitwise equal with and without remat; the smoke
    batch is S = 40, so the SSD runs three chunks of 16."""
    jcfg, _, model = _model_pair(name, remat_policy=policy)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 41))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    l1, g1 = ttrainer.loss_and_grads(model, batch, remat=True)
    l0, g0 = ttrainer.loss_and_grads(model, batch, remat=False)
    assert torch.equal(l1, l0)
    assert all(torch.equal(g1[k], g0[k]) for k in g0)


def test_remat_checkpoints_each_block(monkeypatch):
    """Remat's unit is one block, not one repetition of the pattern (13
    blocks in recurrentgemma-2b): the backward pass holds one block's
    recompute, its scan's steps included, at a time."""
    _, _, model = _model_pair("recurrentgemma-2b", remat_policy="dots")
    units, real = [], torch.utils.checkpoint.checkpoint

    def spy(fn, *args, **kw):
        units.append(args[0])
        return real(fn, *args, **kw)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    toks = np.random.default_rng(2).integers(0, 512, (2, 41))
    tmodel.loss_fn(model, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert len(units) == model.cfg.n_layers == 3
    assert all(u is b for u, b in zip(units, model.blocks))


def test_dots_policy_keeps_the_recurrent_weight_products():
    """Under "dots" the SSD's and RG-LRU's weight products (mm) are kept
    and the scans' batched products (bmm) recomputed."""
    ops = torch.ops.aten

    class Count(torch.utils._python_dispatch.TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            for k in self.n:
                if func is getattr(ops, k).default:
                    self.n[k] += 1
            return func(*args, **(kwargs or {}))

    for name in RECURRENT:
        counts = {}
        for policy in ("nothing", "dots"):
            _, _, model = _model_pair(name, remat_policy=policy)
            toks = np.random.default_rng(2).integers(0, 512, (2, 41))
            loss = tmodel.loss_fn(model, {"tokens": toks[:, :-1],
                                          "labels": toks[:, 1:]})
            with Count() as c:
                loss.backward()
            counts[policy] = c.n
        assert counts["dots"]["mm"] < counts["nothing"]["mm"], name
        assert counts["dots"]["bmm"] == counts["nothing"]["bmm"] > 0, name


def test_serve_engine_groups_waves_by_prompt_length(monkeypatch):
    """No padding token enters a recurrent state: each wave's prompts are
    of one length, and a request served beside others of other lengths
    gets the tokens it gets alone, and JAX's engine's."""
    jcfg, params, model = _model_pair("mamba2-370m")
    seen = []
    real = tmodel.prefill_step

    def spy(model_, prompts, **kw):
        seen.append(tuple(prompts.shape))
        return real(model_, prompts, **kw)
    monkeypatch.setattr(tmodel, "prefill_step", spy)
    rng = np.random.default_rng(11)
    lens = (5, 9, 5, 12, 9)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    eng = teng.ServeEngine(model, n_slots=4, cache_dtype=torch.float32)
    for i, p in enumerate(prompts):
        eng.submit(teng.Request(i, p, max_new=4))
    together = {r.rid: r.out for r in eng.run()}
    assert sorted(seen) == sorted([(2, 5), (2, 9), (1, 12)])
    for i, p in enumerate(prompts):
        one = teng.ServeEngine(model, n_slots=1, cache_dtype=torch.float32)
        one.submit(teng.Request(i, p, max_new=4))
        assert one.run()[0].out == together[i]
    jen = jeng.ServeEngine(jcfg, params, n_slots=4,
                           cache_dtype=jnp.float32)
    for i, p in enumerate(prompts):
        jen.submit(jeng.Request(i, p, max_new=4))
    assert {r.rid: r.out for r in jen.run()} == together


def test_mamba2_lm_state_roundtrip(tmp_path):
    """A mamba2 smoke model and its AdamW state after one step restore bit
    for bit into a fresh model (the SSD's leaves under ``params/blocks/
    <layer>/mixer/<name>``); the next step's loss is equal."""
    cfg = tconfigs.get_smoke("mamba2-370m")
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=5)
    model, state = ttrainer.init_train_state(cfg, opt, seed=1, device="cpu")
    toks = np.arange(82).reshape(2, 41) % cfg.vocab_size
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = ttrainer.make_step_fn(cfg, opt)
    model, state, _ = step(model, state, batch)
    ck = CheckpointManager(str(tmp_path), async_write=False)
    ck.save(1, {"params": model, "opt": state})
    with np.load(tmp_path / "step_00000001.npz") as z:
        keys = set(z.files)
        assert z["params/blocks/1/mixer/conv_w"].shape == (
            cfg.conv_width, cfg.ssm_inner + 2 * cfg.ssm_state)
    for name in ("w_x", "dt_bias", "a_log", "d_skip", "w_out"):
        assert f"params/blocks/0/mixer/{name}" in keys
        assert f"opt/m/blocks.1.mixer.{name}" in keys
    fresh, fstate = ttrainer.init_train_state(cfg, opt, seed=2,
                                              device="cpu")
    got = ck.restore(1, {"params": fresh, "opt": fstate}, device="cpu")
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              fresh.state_dict().items()):
        assert torch.equal(a, b), k
    _, _, m1 = step(model, state, batch)
    _, _, m2 = step(fresh, got["opt"], batch)
    assert torch.equal(m1["loss"], m2["loss"])


@pytest.mark.parametrize("name", RECURRENT)
def test_decode_cache_does_not_grow_with_the_position(name):
    """A recurrent layer's cache bytes are the same at any allocation;
    recurrentgemma's local attention caps its ring at the window."""
    cfg = tconfigs.get_smoke(name)

    def nbytes(alloc):
        return sum(t.numel() * t.element_size()
                   for c in tmodel.init_cache(cfg, 1, alloc, torch.float32,
                                              "cpu")
                   for t in c.values() if isinstance(t, torch.Tensor))
    assert nbytes(64) == nbytes(4096) == nbytes(524_288)


# ----------------------------------------------------------------------
# Part B: the paper's host-side models, bit for bit
def _operand(rng, m, n, d):
    return np.where(rng.random((m, n)) < d, rng.normal(size=(m, n)),
                    0.0).astype(np.float64)


def _pair_formats(dense, section=64, block=8):
    jc, tc = jcrs.CRS.from_dense(dense), tcrs.CRS.from_dense(dense)
    return (jc, tc, jincrs.InCRS.from_crs(jc, section, block),
            tincrs.InCRS.from_crs(tc, section, block))


def test_crs_and_incrs_storage_and_models_equal_jax():
    rng = np.random.default_rng(0)
    dense = _operand(rng, 40, 700, 0.06)
    jc, tc, ji, ti = _pair_formats(dense)
    assert (tc.density, tc.storage_words()) == (jc.density,
                                                jc.storage_words())
    assert (ti.storage_words(), ti.storage_ratio()) == \
        (ji.storage_words(), ji.storage_ratio())
    for i in range(0, 40, 7):
        for sec in range(ji.n_sections):
            jp, jb = ji.counter(i, sec)
            tp, tb = ti.counter(i, sec)
            assert tp == jp and np.array_equal(tb, jb)
    for n, d, b, s in ((4096, 0.04, 32, 256), (700, 0.3, 8, 64)):
        assert tcrs.expected_ma_crs(n, d) == jcrs.expected_ma_crs(n, d)
        assert tcrs.expected_ma_jad(n, d) == jcrs.expected_ma_jad(n, d)
        assert tcrs.expected_ma_coo(40, n, d) == \
            jcrs.expected_ma_coo(40, n, d)
        assert tincrs.expected_ma_incrs(b) == jincrs.expected_ma_incrs(b)
        assert tincrs.expected_ma_reduction(n, d, b) == \
            jincrs.expected_ma_reduction(n, d, b)
        assert tincrs.expected_storage_ratio(d, s) == \
            jincrs.expected_storage_ratio(d, s)


@pytest.mark.parametrize("fmt", ["crs", "incrs", "incrs_binary"])
def test_locate_counts_and_traces_equal_jax(fmt):
    rng = np.random.default_rng(1)
    dense = _operand(rng, 24, 600, 0.08)
    jc, tc, ji, ti = _pair_formats(dense)
    j_op, t_op = {"crs": (jc, tc)}.get(fmt, (ji, ti))
    meth = "locate_binary" if fmt == "incrs_binary" else "locate"
    for _ in range(300):
        i, j = int(rng.integers(24)), int(rng.integers(600))
        jt, tt = [], []
        jv, jma = getattr(j_op, meth)(i, j, jt)
        tv, tma = getattr(t_op, meth)(i, j, tt)
        assert (tv, tma, tt) == (jv, jma, jt)
        assert tv == dense[i, j]


@pytest.mark.parametrize("fmt", ["crs", "incrs"])
def test_column_and_row_gathers_equal_jax(fmt):
    rng = np.random.default_rng(2)
    dense = _operand(rng, 30, 512, 0.05)
    jc, tc, ji, ti = _pair_formats(dense)
    j_op, t_op = (jc, tc) if fmt == "crs" else (ji, ti)
    for j in rng.choice(512, 12, replace=False):
        jt, tt = [], []
        jcol, jma = j_op.get_column(int(j), jt)
        tcol, tma = t_op.get_column(int(j), tt)
        assert np.array_equal(tcol, jcol) and tma == jma and tt == jt
    for i in range(30):
        jt, tt = [], []
        ji_, jv, jma = j_op.get_row(i, jt)
        ti_, tv, tma = t_op.get_row(i, tt)
        assert np.array_equal(ti_, ji_) and np.array_equal(tv, jv)
        assert tma == jma and tt == jt


def test_spmm_host_algorithms_equal_jax():
    rng = np.random.default_rng(3)
    a = _operand(rng, 12, 90, 0.2)
    b = _operand(rng, 90, 10, 0.15)
    jc, tc, ji, ti = _pair_formats(b, section=32, block=8)
    ja, ta = jcrs.CRS.from_dense(a), tcrs.CRS.from_dense(a)
    for jb, tb in ((jc, tc), (ji, ti)):
        jt, tt = [], []
        jout, jma = jspmm.spmm_colaccess(ja, jb, jt)
        tout, tma = tspmm.spmm_colaccess(ta, tb, tt)
        assert np.array_equal(tout, jout) and tma == jma and tt == jt
    bt = _operand(rng, 14, 90, 0.25)
    jbt, tbt = jcrs.CRS.from_dense(bt), tcrs.CRS.from_dense(bt)
    jout, jcyc = jspmm.spmm_index_match(ja, jbt)
    tout, tcyc = tspmm.spmm_index_match(ta, tbt)
    assert np.array_equal(tout, jout) and np.array_equal(tcyc, jcyc)
    ai, av, _ = ta.get_row(0)
    bi, bv, _ = tbt.get_row(0)
    assert tspmm.index_match_dot(ai, av, bi, bv) == \
        jspmm.index_match_dot(ai, av, bi, bv)


def test_cache_sim_equals_jax():
    """The Fig. 3 instrument: the LRU sets, and the hierarchy's statistics
    on CRS's and InCRS's column-gather traces and a sequential stream."""
    for mod in (jcache, tcache):
        c = mod._SetAssocCache(size_bytes=2 * 64, assoc=2, block_bytes=64)
        assert [c.access(b) for b in (0, 1, 0, 2, 0, 1)] == \
            [False, False, True, False, True, False]
    rng = np.random.default_rng(4)
    dense = _operand(rng, 128, 4096, 0.04)
    jc, tc = jcrs.CRS.from_dense(dense), tcrs.CRS.from_dense(dense)
    ji, ti = jincrs.InCRS.from_crs(jc), tincrs.InCRS.from_crs(tc)
    traces = {}
    for key, op in (("crs", tc), ("incrs", ti)):
        traces[key] = []
        for j in (5, 77, 1024, 4000):
            op.get_column(j, traces[key])
    jtr = {"crs": [], "incrs": []}
    for j in (5, 77, 1024, 4000):
        jc.get_column(j, jtr["crs"])
        ji.get_column(j, jtr["incrs"])
    assert traces == jtr
    traces["stream"] = list(range(0, 8 * 4096))
    for key, tr in traces.items():
        for kw in ({}, {"prefetch_degree": 2, "mem_latency": 300}):
            got = tcache.Hierarchy(**kw).simulate(tr)
            want = jcache.Hierarchy(**kw).simulate(tr)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), key
            assert got.l1_miss_rate == want.l1_miss_rate


@pytest.mark.parametrize("seed", range(6))
def test_node_alg2_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 150))
    vec = []
    for d in rng.uniform(0.02, 0.7, 2):
        idx = np.nonzero(rng.random(n) < d)[0]
        vec += [idx, rng.normal(size=len(idx))]
    rounds = int(rng.integers(4, 65))
    assert tmesh.node_alg2(*vec, rounds=rounds) == \
        jmesh.node_alg2(*vec, rounds=rounds)


def test_mesh_latency_models_equal_jax():
    rng = np.random.default_rng(5)
    for m, n, k, d in ((25, 20, 160, 0.12), (70, 64, 300, 0.03),
                       (40, 40, 128, 0.6)):
        a, bt = _operand(rng, m, k, d), _operand(rng, n, k, d * 1.5)
        ja, ta = jcrs.CRS.from_dense(a), tcrs.CRS.from_dense(a)
        jb, tb = jcrs.CRS.from_dense(bt), tcrs.CRS.from_dense(bt)
        for want, got in zip(jmesh.merge_cycles_matrix(ja, jb, True),
                             tmesh.merge_cycles_matrix(ta, tb, True)):
            assert np.array_equal(got, want)
        assert np.array_equal(tmesh.merge_cycles_matrix(ta, tb),
                              jmesh.merge_cycles_matrix(ja, jb))
        for mesh in (8, 16, 64):
            assert dataclasses.asdict(tmesh.sync_mesh_latency(ta, tb, mesh)) \
                == dataclasses.asdict(jmesh.sync_mesh_latency(ja, jb, mesh))
            assert dataclasses.asdict(tmesh.sync_mesh_latency(
                ta, tb, mesh, rounds=16)) == dataclasses.asdict(
                jmesh.sync_mesh_latency(ja, jb, mesh, rounds=16))
            assert dataclasses.asdict(tmesh.conventional_mm_latency(
                m, n, k, mesh)) == dataclasses.asdict(
                jmesh.conventional_mm_latency(m, n, k, mesh))
        for k_fpic, contention in ((1, True), (8, True), (4, False)):
            assert dataclasses.asdict(tmesh.fpic_latency(
                ta, tb, k_fpic, port_contention=contention)) == \
                dataclasses.asdict(jmesh.fpic_latency(
                    ja, jb, k_fpic, port_contention=contention))


def test_resource_matching_equals_jax():
    for n in (8, 16, 32, 64, 96, 128, 256):
        for fn in ("fpic_units_same_bw", "fpic_units_same_buffer",
                   "conv_mesh_same_bw", "bandwidth_kb_per_cycle",
                   "buffer_kb"):
            assert getattr(tmesh, fn)(n) == getattr(jmesh, fn)(n), fn
        assert tmesh.buffer_kb(n, 16) == jmesh.buffer_kb(n, 16)
    assert (tmesh.R_DEFAULT, tmesh.FPIC_N, tmesh.W_IDX, tmesh.W_VAL,
            tmesh.W_TOT) == (jmesh.R_DEFAULT, jmesh.FPIC_N, jmesh.W_IDX,
                             jmesh.W_VAL, jmesh.W_TOT)
