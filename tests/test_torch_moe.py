"""The port's MoE FFN (``repro_torch.models.layers.MoE``) against JAX's
``layers.moe`` on the CPU: the capacity path (with drops), the decode
path and the S <= k path, with and without shared experts; routing ties
against ``jax.lax.top_k``; the layer's grads (the router's included)
against ``jax.grad``; remat with the MoE present; a float64 copy of the
layer taking a held routing.

Inputs and weights are made with numpy from a seed and handed to both
packages, in f32 (the JAX model computes bf16 configs in f32, ROADMAP
fault C3). Tolerances: rtol = atol = 1e-4 on outputs, grads ``1e-4 *
max|g|`` per tensor; routing and drops equal; remat and repeat runs
bitwise.
"""
import dataclasses

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401

torch = pytest.importorskip("torch")

import jax                                                # noqa: E402
import jax.numpy as jnp                                   # noqa: E402

from repro import configs as jconfigs                     # noqa: E402
from repro.models import layers as jlayers                # noqa: E402
from repro.models import model as jmodel                  # noqa: E402
from repro_torch import configs as tconfigs               # noqa: E402
from repro_torch import convert                           # noqa: E402
from repro_torch.models import layers as tlayers          # noqa: E402
from repro_torch.models import model as tmodel            # noqa: E402
from repro_torch.train import trainer as ttrainer         # noqa: E402

TOL = 1e-4
NAMES = ("router", "w_gate", "w_up", "w_down", "ws_gate", "ws_up", "ws_down")


def _cfgs(name, **over):
    return (dataclasses.replace(jconfigs.get_smoke(name), **over),
            dataclasses.replace(tconfigs.get_smoke(name), **over))


def _weights(cfg, seed, scale=0.2):
    """numpy weights of one MoE layer, JAX's names and shapes."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    shapes = {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
              "w_down": (e, f, d)}
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        shapes.update(ws_gate=(d, fs), ws_up=(d, fs), ws_down=(fs, d))
    return {k: (rng.normal(size=v) * scale).astype(np.float32)
            for k, v in shapes.items()}


def _layer(cfg, w):
    layer = tlayers.MoE(cfg, device="cpu")
    with torch.no_grad():
        for k, v in w.items():
            getattr(layer, k).copy_(torch.from_numpy(v))
    return layer


def _x(b, s, d, seed):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


def _jax_route(cfg, w, x):
    """JAX's top-k experts of each token, from its own pieces."""
    logits = jnp.einsum("bsd,de->bse", x, w["router"]).astype(jnp.float32)
    _, topi = jax.lax.top_k(logits, cfg.n_experts_per_tok)
    return np.asarray(topi)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# (arch, capacity factor, B, S, mode): the capacity path at the published
# factor, with drops at 0.5, the decode path, the S <= k path
CASES = [
    ("mixtral-8x7b", 1.25, 2, 24, "train"),
    ("mixtral-8x7b", 0.5, 2, 24, "train"),
    ("mixtral-8x7b", 1.25, 3, 1, "decode"),
    ("mixtral-8x7b", 1.25, 2, 2, "prefill"),
    ("qwen2-moe-a2.7b", 1.25, 2, 20, "prefill"),
    ("qwen2-moe-a2.7b", 0.5, 2, 20, "train"),
    ("qwen2-moe-a2.7b", 1.25, 2, 1, "decode"),
    ("qwen2-moe-a2.7b", 1.25, 2, 3, "train"),
]


@pytest.mark.parametrize("name,cf,b,s,mode", CASES)
def test_moe_matches_jax(name, cf, b, s, mode):
    jcfg, tcfg = _cfgs(name, capacity_factor=cf)
    w = _weights(tcfg, seed=s + b)
    x = _x(b, s, tcfg.d_model, seed=s)
    want = jlayers.moe({k: jnp.asarray(v) for k, v in w.items()}, jcfg,
                       jnp.asarray(x), mode=mode)
    layer = _layer(tcfg, w)
    layer.route_log = []
    with torch.no_grad():
        got = layer(torch.from_numpy(x), mode=mode)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want)
    route, = layer.route_log
    np.testing.assert_array_equal(route.topi.numpy(),
                                  _jax_route(jcfg, w, jnp.asarray(x)))
    dense = mode == "decode" or s <= tcfg.n_experts_per_tok
    assert (route.rows is None) == dense
    if not dense:
        cap = tlayers.moe_capacity(s, tcfg)
        assert cap == min(s, max(1, int(np.ceil(
            s * tcfg.n_experts_per_tok * cf / tcfg.n_experts))))
        assert route.capacity == cap
        # every kept (token, expert) is one of the token's top k, the
        # kept tokens of an expert are its first routed ones in order
        topi = route.topi.numpy()
        rows, valid = route.rows.numpy(), route.valid.numpy()
        for e in range(tcfg.n_experts):
            for bi in range(b):
                sl = slice(bi * cap, (bi + 1) * cap)
                toks = rows[e, sl] - bi * s
                routed = [t for t in range(s) if e in topi[bi, t]]
                assert list(toks[valid[e, sl]]) == routed[:cap]
        if cf < 1:
            assert route.dropped() > 0


def test_moe_drops_the_tokens_jax_drops():
    """At capacity factor 0.5 the same (token, expert) pairs lose their
    slot: a token's output from the routed experts is JAX's exactly
    where JAX dropped it (shared experts off, so a token dropped by all
    its experts outputs 0 in both)."""
    jcfg, tcfg = _cfgs("mixtral-8x7b", capacity_factor=0.5)
    w = _weights(tcfg, seed=3)
    x = _x(2, 24, tcfg.d_model, seed=4)
    want = np.asarray(jlayers.moe({k: jnp.asarray(v) for k, v in w.items()},
                                  jcfg, jnp.asarray(x), mode="train"))
    layer = _layer(tcfg, w)
    layer.route_log = []
    with torch.no_grad():
        got = layer(torch.from_numpy(x), mode="train").numpy()
    route, = layer.route_log
    kept = np.zeros((2 * 24,), np.int64)
    np.add.at(kept, route.rows.numpy()[route.valid.numpy()], 1)
    zero_j = np.all(want.reshape(-1, tcfg.d_model) == 0, axis=1)
    assert route.dropped() > 0 and zero_j.any()
    np.testing.assert_array_equal(kept == 0, zero_j)
    _close(got, want)


@pytest.mark.parametrize("case", ["zero_router", "bf16_router"])
def test_routing_ties_go_to_the_lower_expert_as_jax(case):
    """Planted ties: a zero router (every logit 0), then a router rounded
    to bf16 (logits equal in blocks); the port routes to the experts
    ``jax.lax.top_k`` picks (``torch.topk`` breaks ties otherwise)."""
    _, tcfg = _cfgs("qwen2-moe-a2.7b")
    e, k = tcfg.n_experts, tcfg.n_experts_per_tok
    rng = np.random.default_rng(5)
    if case == "zero_router":
        logits = np.zeros((2, 16, e), np.float32)
    else:
        # two distinct bf16 values per token, repeated across experts
        base = rng.normal(size=(2, 16, 2)).astype(np.float32)
        logits = base[..., rng.integers(0, 2, e)]
        logits = torch.from_numpy(logits).bfloat16().float().numpy()
    _, want = jax.lax.top_k(jnp.asarray(logits), k)
    _, got = tlayers.top_k_lower(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    route = tlayers.moe_route(torch.from_numpy(logits), tcfg, dense=False)
    np.testing.assert_array_equal(route.topi.numpy(), np.asarray(want))
    if case == "zero_router":
        assert got[0, 0].tolist() == list(range(k))
    # and the layer itself, on a zero router
    w = _weights(tcfg, seed=6)
    w["router"][:] = 0.0
    jcfg, _ = _cfgs("qwen2-moe-a2.7b")
    x = _x(2, 12, tcfg.d_model, seed=7)
    layer = _layer(tcfg, w)
    layer.route_log = []
    with torch.no_grad():
        out = layer(torch.from_numpy(x), mode="train")
    assert layer.route_log[0].topi.unique().tolist() == list(range(k))
    _close(out, jlayers.moe({k_: jnp.asarray(v) for k_, v in w.items()},
                            jcfg, jnp.asarray(x), mode="train"))


@pytest.mark.parametrize("name,mode,s", [
    ("mixtral-8x7b", "train", 24), ("qwen2-moe-a2.7b", "train", 20),
    ("qwen2-moe-a2.7b", "decode", 1), ("mixtral-8x7b", "train", 2)])
def test_moe_grads_match_jax(name, mode, s):
    jcfg, tcfg = _cfgs(name)
    w = _weights(tcfg, seed=8)
    x = _x(2, s, tcfg.d_model, seed=9)
    cot = np.random.default_rng(10).normal(size=x.shape).astype(np.float32)

    def jf(p, x_):
        return jnp.sum(jlayers.moe(p, jcfg, x_, mode=mode) * cot)
    jg, jgx = jax.grad(jf, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    layer = _layer(tcfg, w)
    tx = torch.from_numpy(x.copy()).requires_grad_()
    (layer(tx, mode=mode) * torch.from_numpy(cot)).sum().backward()
    for k in w:
        want = np.asarray(jg[k])
        scale = float(np.abs(want).max())
        assert scale > 0, k
        np.testing.assert_allclose(getattr(layer, k).grad.numpy(), want,
                                   rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=TOL * float(np.abs(jgx).max()))


def test_moe_forward_and_grads_repeat_bitwise():
    """The gather's backward and the combine add in expert order: two
    runs give the same bits (k = 4, shared experts on)."""
    _, tcfg = _cfgs("qwen2-moe-a2.7b")
    w = _weights(tcfg, seed=11)
    x = torch.from_numpy(_x(2, 20, tcfg.d_model, seed=12))
    runs = []
    for _ in range(2):
        layer = _layer(tcfg, w)
        tx = x.clone().requires_grad_()
        out = layer(tx, mode="train")
        out.square().sum().backward()
        runs.append([out.detach(), tx.grad] +
                    [getattr(layer, k).grad for k in w])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_held_route_replaces_the_router_choice():
    """A float64 copy of the layer given the f32 run's routing computes
    the same function to f64 precision; its own router would pick the
    same experts here, and a held routing that differs is followed."""
    _, tcfg = _cfgs("mixtral-8x7b")
    w = _weights(tcfg, seed=13)
    x = _x(2, 24, tcfg.d_model, seed=14)
    layer = _layer(tcfg, w)
    layer.route_log = []
    with torch.no_grad():
        out = layer(torch.from_numpy(x), mode="train")
    route = layer.route_log[0]
    c64 = dataclasses.replace(tcfg, dtype="float64", param_dtype="float64")
    l64 = tlayers.MoE(c64, device="cpu")
    l64.load_state_dict(layer.state_dict())
    l64.held_route = route
    with torch.no_grad():
        o64 = l64(torch.from_numpy(x).double(), mode="train")
    _close(out, o64.float(), 1e-5)
    # a routing with expert 0 and 1 for every token is followed
    flip = tlayers.moe_route(torch.zeros(2, 24, tcfg.n_experts), tcfg,
                             dense=False)
    l64.held_route = flip
    l64.route_log = []
    with torch.no_grad():
        l64(torch.from_numpy(x).double(), mode="train")
    assert l64.route_log[0] is flip
    assert set(flip.topi.unique().tolist()) == {0, 1}


# ----------------------------------------------------------------------
def _pair(name, **over):
    jcfg, tcfg = _cfgs(name, **over)
    params, _ = jmodel.init(jcfg, jax.random.PRNGKey(0))
    model = convert.model_from_jax(tcfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    return jcfg, params, model


def test_convert_maps_the_moe_leaves():
    jcfg, params, model = _pair("qwen2-moe-a2.7b")
    ffn = params["groups"]["block0_attn"]["ffn"]
    assert set(ffn) == set(NAMES)
    names = {n for n, _ in model.named_parameters()}
    for layer in range(jcfg.n_layers):
        for k in NAMES:
            got = dict(model.named_parameters())[f"blocks.{layer}.ffn.{k}"]
            np.testing.assert_array_equal(got.detach().numpy(),
                                          np.asarray(ffn[k][layer]))
            assert f"blocks.{layer}.ffn.{k}" in names
    # the init draws the 3-D expert tensors, zeros only the norms
    init = tmodel.init(tconfigs.get_smoke("qwen2-moe-a2.7b"), seed=1,
                       device="cpu")
    for n, p in init.named_parameters():
        if p.ndim == 1:
            assert float(p.detach().abs().max()) == 0.0, n
        else:
            assert 0.015 < float(p.detach().std()) < 0.025, n


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("name", ["mixtral-8x7b", "qwen2-moe-a2.7b"])
def test_remat_changes_no_value_with_the_moe(name, policy):
    _, _, model = _pair(name, remat_policy=policy)
    from repro_torch.data.pipeline import SyntheticTokens
    batch = SyntheticTokens(model.cfg.vocab_size, 4, 24, seed=1).batch_at(0)
    l1, g1 = ttrainer.loss_and_grads(model, batch, remat=True)
    l0, g0 = ttrainer.loss_and_grads(model, batch, remat=False)
    assert torch.equal(l1, l0)
    assert all(torch.equal(g1[k], g0[k]) for k in g0)
