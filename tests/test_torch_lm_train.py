"""The port's LM training path (train-mode chunked attention, loss_fn with
remat, loss_and_grads with microbatches, the AdamW step, the launcher and
the sparse-FFN example) against the JAX package on the CPU, for the
dense, MoE, embeds and recurrent (SSD, RG-LRU) smoke configs.

Inputs come from numpy seeds and ``repro.data.pipeline.SyntheticTokens``
and go to both packages; the weights are JAX's, carried over by
``convert.model_from_jax``. The smoke configs compute in f32 (the JAX
model computes a bf16 config in f32: ROADMAP fault C3). Tolerances:
loss rtol 1e-5, grads ``1e-5 * max|g|`` over each tensor (both sum in
f32, in another order); remat on/off bitwise; microbatching rtol 5e-4 /
atol 1e-5 (JAX's ``test_grad_accumulation_equivalence``); three AdamW
steps ``1e-4 * max|p|``; the chunked attention rtol = atol = 3e-5
(JAX's ``test_flash_attention_matches_reference``) and its grads
``1e-5 * max|g|``.
"""
import dataclasses
import json

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401

torch = pytest.importorskip("torch")

import jax                                                # noqa: E402
import jax.numpy as jnp                                   # noqa: E402
from _recurrent_draw import MIXER_LEAVES, draw_mixer_leaf # noqa: E402

from repro import configs as jconfigs                     # noqa: E402
from repro.data.pipeline import SyntheticTokens           # noqa: E402
from repro.models import config as jconfig                # noqa: E402
from repro.models import layers as jlayers                # noqa: E402
from repro.models import model as jmodel                  # noqa: E402
from repro.train import optimizer as jopt                 # noqa: E402
from repro.train import trainer as jtrainer               # noqa: E402
from repro_torch import configs as tconfigs               # noqa: E402
from repro_torch import convert                           # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops as tops               # noqa: E402
from repro_torch.models import config as tconfig          # noqa: E402
from repro_torch.models import layers as tlayers          # noqa: E402
from repro_torch.models import model as tmodel            # noqa: E402
from repro_torch.train import optimizer as topt           # noqa: E402
from repro_torch.train import trainer as ttrainer         # noqa: E402

GRAD_TOL = 1e-5
STEP_TOL = 1e-4
ATTN_TOL = 3e-5
ARCHS = ("granite-34b", "phi3-medium-14b", "mistral-large-123b",
         "llama3-405b", "mixtral-8x7b", "qwen2-moe-a2.7b", "musicgen-medium",
         "internvl2-1b", "mamba2-370m", "recurrentgemma-2b")
# the MoE, embeds and recurrent architectures
FAMILIES = ARCHS[4:]


def _cfgs(name, **over):
    return (dataclasses.replace(jconfigs.get_smoke(name), **over),
            dataclasses.replace(tconfigs.get_smoke(name), **over))


def _pair(name, seed=0, sparse=False, **over):
    """(JAX cfg, JAX params, port model) on the same weights."""
    jcfg, tcfg = _cfgs(name, **over)
    if sparse:
        jcfg = dataclasses.replace(jcfg,
                                   sparsity=jconfig.BlockSparsity(block=16))
        tcfg = dataclasses.replace(tcfg,
                                   sparsity=tconfig.BlockSparsity(block=16))
    params, _ = jmodel.init(jcfg, jax.random.PRNGKey(seed))
    # the recurrent mixers' leaves: their state carries the output
    rng = np.random.default_rng(seed + 9)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.asarray(draw_mixer_leaf(path[-1].key, v.shape,
                                                    rng), v.dtype)
        if path[-1].key in MIXER_LEAVES else v, params)
    if sparse:
        rng = np.random.default_rng(6)
        for blk in params["groups"].values():
            ffn = blk["ffn"]
            for k in [k for k in ffn if k.startswith("mask_")]:
                ffn[k] = jnp.asarray(rng.random(ffn[k].shape) < 0.5,
                                     jnp.float32)
    model = convert.model_from_jax(tcfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    return jcfg, params, model


def _by_name(cfg, tree):
    """A JAX params-shaped tree as {port parameter name: array}, the
    mapping ``convert.model_from_jax`` uses; masks (buffers in the port)
    left out."""
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
                        if not sub.startswith("mask_"):
                            out[f"{pre}{name}.{sub}"] = np.asarray(arr[g])
                else:
                    out[f"{pre}{name}"] = np.asarray(leaf[g])
    return {k: np.asarray(v) for k, v in out.items()}


def _batch(cfg, batch=4, seq=24, seed=1, step=0):
    """A SyntheticTokens batch; an embeds config's carries its
    ``prefix_embeds``."""
    npfx = cfg.n_prefix_embeds if cfg.input_mode == "embeds" else 0
    return SyntheticTokens(cfg.vocab_size, batch, seq, seed=seed,
                           n_prefix=npfx,
                           d_model=cfg.d_model).batch_at(step)


def _close_by_tensor(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_jax(name):
    jcfg, params, model = _pair(name)
    batch = _batch(jcfg)
    jl, jg = jax.value_and_grad(lambda p: jmodel.loss_fn(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}))(params)
    tl, tg = ttrainer.loss_and_grads(model, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = _by_name(jcfg, jg)
    assert set(tg) == set(want) == set(dict(model.named_parameters()))
    for k, g in tg.items():
        _close_by_tensor(g.numpy(), want[k], GRAD_TOL)


def test_loss_masks_negative_labels_as_jax():
    jcfg, params, model = _pair("granite-34b")
    batch = _batch(jcfg)
    batch["labels"] = batch["labels"].copy()
    batch["labels"][:, ::3] = -1
    jl = jmodel.loss_fn(jcfg, params,
                        {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        np.testing.assert_allclose(float(tmodel.loss_fn(model, batch)),
                                   float(jl), rtol=1e-5)
    batch["labels"][:] = -1                       # nothing counts: loss 0
    with torch.no_grad():
        assert float(tmodel.loss_fn(model, batch)) == 0.0
    # prefix embeds (the embeds front end): the prefix positions carry no
    # loss, and masked labels still count for nothing
    jcfg, params, model = _pair("internvl2-1b")
    batch = _batch(jcfg)
    assert batch["prefix_embeds"].shape == (4, jcfg.n_prefix_embeds,
                                            jcfg.d_model)
    batch["labels"] = batch["labels"].copy()
    batch["labels"][:, ::3] = -1
    jl = jmodel.loss_fn(jcfg, params,
                        {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        np.testing.assert_allclose(float(tmodel.loss_fn(model, batch)),
                                   float(jl), rtol=1e-5)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_changes_no_value(policy):
    """Loss and grads bitwise equal with and without remat, for both
    policies, on the dense and the chunked attention branch."""
    _, _, model = _pair("phi3-medium-14b", remat_policy=policy)
    batch = _batch(model.cfg)
    for threshold in (8192, 16):
        old = tlayers.FLASH_THRESHOLD
        tlayers.FLASH_THRESHOLD = threshold
        try:
            l1, g1 = ttrainer.loss_and_grads(model, batch, remat=True)
            l0, g0 = ttrainer.loss_and_grads(model, batch, remat=False)
        finally:
            tlayers.FLASH_THRESHOLD = old
        assert torch.equal(l1, l0)
        assert all(torch.equal(g1[k], g0[k]) for k in g0)


def test_dots_policy_saves_the_weight_products():
    """"dots" keeps aten.mm's outputs and recomputes the attention's
    batched products; "nothing" keeps no op's output."""
    ops = torch.ops.aten
    policy = torch.utils.checkpoint.CheckpointPolicy
    assert tmodel._keep_products(None, ops.mm.default) == policy.MUST_SAVE
    assert tmodel._keep_products(None, ops.addmm.default) == \
        policy.MUST_SAVE
    assert tmodel._keep_products(None, ops.bmm.default) == \
        policy.PREFER_RECOMPUTE
    assert tmodel._remat_context("nothing") is \
        torch.utils.checkpoint.noop_context_fn
    with pytest.raises(ValueError, match="remat_policy"):
        tmodel._remat_context("everything")

    # count the forward products that run again in the backward pass
    class Count(torch.utils._python_dispatch.TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            for k in self.n:
                if func is getattr(ops, k).default:
                    self.n[k] += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for policy_name in ("nothing", "dots"):
        _, _, model = _pair("phi3-medium-14b", remat_policy=policy_name)
        loss = tmodel.loss_fn(model, _batch(model.cfg), remat=True)
        with Count() as c:
            loss.backward()
        counts[policy_name] = c.n
    # "dots" recomputes no weight product; "nothing" recomputes them all
    assert counts["dots"]["mm"] < counts["nothing"]["mm"]
    assert counts["dots"]["bmm"] == counts["nothing"]["bmm"]


@pytest.mark.parametrize("n_micro", [2, 4])
def test_grad_accumulation_equivalence(n_micro):
    jcfg, params, model = _pair("granite-34b")
    batch = _batch(jcfg, batch=8)
    l1, g1 = ttrainer.loss_and_grads(model, batch, n_micro=1, remat=False)
    ln, gn = ttrainer.loss_and_grads(model, batch, n_micro=n_micro,
                                     remat=False)
    np.testing.assert_allclose(float(l1), float(ln), rtol=1e-5)
    for k in g1:
        np.testing.assert_allclose(gn[k].numpy(), g1[k].numpy(), rtol=5e-4,
                                   atol=1e-5)
    # and against JAX's accumulation over the same microbatches
    jl, jg = jtrainer.loss_and_grads(
        jcfg, params, {k: jnp.asarray(v) for k, v in batch.items()},
        n_micro=n_micro, remat=False)
    np.testing.assert_allclose(float(ln), float(jl), rtol=1e-5)
    want = _by_name(jcfg, jg)
    for k in gn:
        _close_by_tensor(gn[k].numpy(), want[k], GRAD_TOL)
    with pytest.raises(ValueError, match="not divisible by n_micro=3"):
        ttrainer.loss_and_grads(model, batch, n_micro=3)


@pytest.mark.parametrize("name", FAMILIES)
def test_grad_accumulation_equivalence_moe_and_embeds(name):
    """Two microbatches against one batch and against JAX's accumulation
    (MoE routing and capacity are per sequence, so a split changes no
    route; the prefix embeds split with their tokens; a recurrent state is
    per sequence)."""
    jcfg, params, model = _pair(name)
    batch = _batch(jcfg, batch=4)
    l1, g1 = ttrainer.loss_and_grads(model, batch, n_micro=1, remat=False)
    ln, gn = ttrainer.loss_and_grads(model, batch, n_micro=2, remat=False)
    np.testing.assert_allclose(float(l1), float(ln), rtol=1e-5)
    for k in g1:
        np.testing.assert_allclose(gn[k].numpy(), g1[k].numpy(), rtol=5e-4,
                                   atol=1e-5)
    jl, jg = jtrainer.loss_and_grads(
        jcfg, params, {k: jnp.asarray(v) for k, v in batch.items()},
        n_micro=2, remat=False)
    np.testing.assert_allclose(float(ln), float(jl), rtol=1e-5)
    want = _by_name(jcfg, jg)
    for k in gn:
        _close_by_tensor(gn[k].numpy(), want[k], GRAD_TOL)


def _jax_steps(jcfg, params, opt, batches, n_micro=1):
    step = jax.jit(jtrainer.make_step_fn(jcfg, opt, n_micro=n_micro))
    state = jopt.adamw_init(opt, params)
    out = []
    for b in batches:
        params, state, m = step(params, state,
                                {k: jnp.asarray(v) for k, v in b.items()})
        out.append(m)
    return params, out


ADAMW_ARCH = {"granite": "granite-34b", "phi3": "phi3-medium-14b",
              "sparse_micro": "granite-34b", "mixtral": "mixtral-8x7b",
              "qwen2_micro": "qwen2-moe-a2.7b",
              "musicgen": "musicgen-medium", "internvl2": "internvl2-1b",
              "mamba2": "mamba2-370m", "recurrentgemma": "recurrentgemma-2b"}


@pytest.mark.parametrize("case", list(ADAMW_ARCH))
def test_adamw_steps_match_jax(case):
    """Three steps of ``make_step_fn`` against JAX's, from one init, f32
    moments (int8 moments round to a grid, where one ulp of difference
    can move a slot by a quantum; ``tests/test_torch_train.py`` holds the
    int8 update against JAX's on one shared state)."""
    jcfg, params, model = _pair(ADAMW_ARCH[case],
                                sparse=case == "sparse_micro")
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    n_micro = 2 if case.endswith("_micro") else 1
    batches = [_batch(jcfg, seed=3, step=i) for i in range(3)]
    jparams, jm = _jax_steps(jcfg, params, jopt.AdamWConfig(**opt), batches,
                             n_micro)
    topt_cfg = topt.AdamWConfig(**opt)
    step = ttrainer.make_step_fn(model.cfg, topt_cfg, n_micro=n_micro)
    state = topt.adamw_init(topt_cfg, dict(model.named_parameters()))
    for b, m in zip(batches, jm):
        model, state, tm = step(model, state, b)
        np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(m["grad_norm"]), rtol=1e-4)
    want = _by_name(jcfg, jparams)
    for k, p in model.named_parameters():
        _close_by_tensor(p.detach().numpy(), want[k], STEP_TOL)
    assert int(state["count"]) == 3


def test_block_sparse_masks_stay_fixed():
    """The FFN's block masks are buffers: the step leaves them and the
    pruned blocks' weights' gradients are 0 (JAX stops their gradient)."""
    jcfg, params, model = _pair("granite-34b", sparse=True)
    masks = {k: b.clone() for k, b in model.named_buffers()}
    assert masks and all(k.split(".")[-1].startswith("mask_") for k in masks)
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = ttrainer.make_step_fn(model.cfg, opt)
    state = topt.adamw_init(opt, dict(model.named_parameters()))
    batch = _batch(jcfg)
    _, grads = ttrainer.loss_and_grads(model, batch)
    for k, mask in masks.items():
        w = k.rsplit(".", 1)[0] + "." + k.split(".")[-1][len("mask_"):]
        full = mask.repeat_interleave(16, 0).repeat_interleave(16, 1)
        assert float(grads[w][full == 0].abs().max()) == 0.0
        assert float(grads[w][full == 1].abs().max()) > 0.0
    for _ in range(2):
        model, state, _ = step(model, state, batch)
    for k, b in model.named_buffers():
        assert torch.equal(b, masks[k])
    assert not any(k.split(".")[-1].startswith("mask_")
                   for k in state["m"])


# ----------------------------------------------------------------------
def _attn_inputs(seed=0, b=2, s=64, kv=2, g=3, hd=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, kv, g, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    return q, k, v, pos


@pytest.mark.parametrize("window,cap", [(None, None), (13, None),
                                        (None, 4.0), (9, 4.0)])
def test_train_attention_matches_jax_values_and_grads(window, cap):
    q, k, v, pos = _attn_inputs()
    cot = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)

    def jf(q_, k_, v_):
        out = jlayers._flash_attention(q_, k_, v_, jnp.asarray(pos),
                                       jnp.asarray(pos), window=window,
                                       soft_cap=cap, chunk=16)
        return jnp.sum(out * cot), out
    (_, jout), jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a.copy()).requires_grad_()
                  for a in (q, k, v))
    tp = torch.from_numpy(pos.copy()).long()
    tout = tlayers._flash_attention(tq, tk, tv, tp, tp, window=window,
                                    soft_cap=cap, chunk=16)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=ATTN_TOL, atol=ATTN_TOL)
    (tout * torch.from_numpy(cot)).sum().backward()
    for got, want in zip((tq, tk, tv), jgrads):
        _close_by_tensor(got.grad.numpy(), np.asarray(want), GRAD_TOL)


def test_train_attention_pads_a_ragged_last_chunk():
    """Sk not a multiple of the chunk: the pad keys (position -1) count
    for nothing, as in JAX."""
    q, k, v, pos = _attn_inputs(s=50)
    want = jlayers._flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), window=None, soft_cap=None, chunk=16)
    tp = torch.from_numpy(pos.copy()).long()
    got = tlayers._flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   tp, tp, window=None, soft_cap=None,
                                   chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATTN_TOL,
                               atol=ATTN_TOL)


def test_flash_kernel_refuses_inputs_that_require_grad():
    """The flash kernels have no backward: grad-requiring inputs raise
    (P5) on every device, rather than get a detached output; under
    no_grad, or without grad, the call runs."""
    q, k, v, _ = _attn_inputs(s=20)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for which in range(3):
        args = [tq, tk, tv]
        args[which] = args[which].clone().requires_grad_()
        with pytest.raises(ValueError, match="P5"):
            tops.flash_mha(*args)
        with pytest.raises(ValueError, match="no backward"):
            tflash.flash_attention(*args)
        with torch.no_grad():
            tops.flash_mha(*args)
    tops.flash_mha(tq, tk, tv)


def test_train_mode_long_sequence_trains_through_the_chunked_path(
        monkeypatch):
    """At S >= FLASH_THRESHOLD train mode runs ``_flash_attention`` (no
    kernel launch, wq/wk/wv get gradients), and its loss and grads match
    JAX's flash branch; a prefill at that length takes the kernel's
    wrapper (its plain version on the CPU)."""
    monkeypatch.setattr(jlayers, "FLASH_THRESHOLD", 16)
    monkeypatch.setattr(tlayers, "FLASH_THRESHOLD", 16)
    jcfg, params, model = _pair("granite-34b", flash_chunk=8,
                                sliding_window=12)
    batch = _batch(jcfg, batch=2, seq=20)
    jl, jg = jax.value_and_grad(lambda p: jmodel.loss_fn(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}))(params)
    calls, real = [], tops.flash_mha
    monkeypatch.setattr(tlayers.ops, "flash_mha",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tl, tg = ttrainer.loss_and_grads(model, batch)
    assert calls == []
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = _by_name(jcfg, jg)
    for k, g in tg.items():
        _close_by_tensor(g.numpy(), want[k], GRAD_TOL)
        if k.endswith(("wq", "wk", "wv")):
            assert float(g.abs().max()) > 0
    with torch.no_grad():
        model(torch.from_numpy(batch["tokens"]), mode="prefill")
    assert len(calls) == model.cfg.n_layers


# ----------------------------------------------------------------------
def test_init_train_state_and_build_train_step():
    cfg = tconfigs.get_smoke("granite-34b")
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    model, state = ttrainer.init_train_state(cfg, opt, seed=3, device="cpu")
    again, kept = ttrainer.init_train_state(cfg, opt, seed=3, device="cpu")
    for (k, p), (_, q) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(p, q)
    assert set(state["m"]) == {k for k, _ in model.named_parameters()}
    step = ttrainer.build_train_step(cfg, opt, None, zero1=True)
    plain = ttrainer.make_step_fn(cfg, opt)
    batch = _batch(cfg)
    losses = []
    for _ in range(4):
        old, moments = state, dict(state["m"])
        model, state, m = step(model, state, batch)
        assert state is old                  # the moments updated in place
        assert all(state["m"][n] is t for n, t in moments.items())
        again, kept, m2 = plain(again, kept, batch)
        assert torch.equal(m["loss"], m2["loss"])
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    for (k, p), (_, q) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(p, q), k
    assert all(torch.equal(state[k][n], kept[k][n])
               for k in ("m", "v") for n in state[k])
    with pytest.raises(ValueError, match="built for"):
        ttrainer.make_step_fn(tconfigs.get_smoke("phi3-medium-14b"),
                              opt)(model, state, batch)


def _launch(argv):
    from repro_torch.launch import train
    return train.main(argv)


def test_launcher_trains_and_resumes_bitwise(tmp_path, capsys):
    """20 smoke steps on the CPU, the loss falling; the same run resumed
    from its step-10 checkpoint gives steps 11-20's losses bitwise."""
    base = ["--arch", "granite-34b", "--smoke", "--steps", "20",
            "--device", "cpu", "--seq", "32", "--log-every", "5"]
    full = tmp_path / "full.json"
    _launch(base + ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "10",
                    "--losses-out", str(full)])
    out = capsys.readouterr().out
    assert "arch=granite-34b-smoke" in out and "step    20  loss" in out
    losses = {int(k): v for k, v in json.loads(full.read_text()).items()}
    assert sorted(losses) == list(range(1, 21))
    assert losses[20] < losses[1]
    # a preempted run: only step 10 was written
    part = tmp_path / "part"
    part.mkdir()
    (part / "step_00000010.npz").write_bytes(
        (tmp_path / "ck" / "step_00000010.npz").read_bytes())
    (part / "manifest.json").write_text('{"steps": [10]}')
    resumed = tmp_path / "resumed.json"
    _launch(base + ["--ckpt-dir", str(part), "--resume", "--losses-out",
                    str(resumed)])
    assert "resumed from step 10" in capsys.readouterr().out
    got = {int(k): v for k, v in json.loads(resumed.read_text()).items()}
    assert got == {s: losses[s] for s in range(11, 21)}


@pytest.mark.parametrize("flags,match", [
    (["--prune-final-density", "0.5", "--prune-nm", "2:4"], "not both"),
    (["--prune-nm", "2:4", "--int8-opt"], "--prune-nm cannot be combined"),
    (["--prune-final-density", "0.5", "--int8-opt"],
     "--prune-final-density cannot be combined"),
])
def test_launcher_flag_conflicts(flags, match):
    with pytest.raises(SystemExit, match=match):
        _launch(["--arch", "granite-34b", "--smoke", "--device", "cpu",
                 "--steps", "2"] + flags)


def test_launcher_int8_microbatches_and_unported(capsys):
    """int8 moments and microbatches; the MoE, embeds and SSD
    architectures train through the launcher (a finite loss every step;
    mamba2's smoke config, which item 12 once refused, its loss falling
    at S = 40, three SSD chunks of 16)."""
    loss = _launch(["--arch", "phi3-medium-14b", "--smoke", "--device",
                    "cpu", "--steps", "2", "--seq", "16", "--batch", "4",
                    "--n-micro", "2", "--int8-opt"])
    assert np.isfinite(loss)
    for arch in ("qwen2-moe-a2.7b", "musicgen-medium"):
        capsys.readouterr()
        last = _launch(["--arch", arch, "--smoke", "--device", "cpu",
                        "--steps", "6", "--seq", "16", "--batch", "4",
                        "--n-micro", "2", "--lr", "3e-3", "--log-every",
                        "1"])
        out = capsys.readouterr().out
        assert f"arch={arch}-smoke" in out and np.isfinite(last)
        assert out.count("  loss ") == 6
    capsys.readouterr()
    losses = []
    for seed in (0, 0):
        losses.append(_launch(["--arch", "mamba2-370m", "--smoke",
                               "--device", "cpu", "--steps", "8", "--seq",
                               "40", "--batch", "4", "--lr", "3e-3",
                               "--log-every", "1", "--seed", str(seed)]))
    out = capsys.readouterr().out
    assert "arch=mamba2-370m-smoke" in out and out.count("  loss ") == 16
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    first = float(out.split("  loss ")[1].split()[0])
    assert losses[0] < first


def test_sparse_lm_example_on_cpu(capsys):
    from repro_torch.examples import train_sparse_lm
    out = train_sparse_lm.main(["--device", "cpu", "--steps", "6",
                                "--d-model", "64", "--vocab", "256",
                                "--seq", "32", "--block", "16"])
    for r in out.values():
        assert r["last"] < r["first"]
    text = capsys.readouterr().out
    assert "dense-lm" in text and "sparse-lm" in text
    assert "final losses" in text
