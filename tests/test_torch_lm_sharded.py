"""The sharded LM on CPU meshes against the port's one-device LM, for the
dense and embeds smoke configs: the train step's gradients and moments,
and prefill and decode logits.

Meshes of the CPU named N times (``launch.mesh.Mesh``): (data 2, model 4);
(data 1, model 8), on which a shard of the flat q/k/v columns is half a
head (the smoke configs' head dim is 16); (pod 2, data 2, model 2), whose
batch splits over (pod, data), or stays whole where 4 does not divide it;
and (data 2, model 3) for a config whose padded vocab the model axis does
not divide (the table and the head stay whole, as ``resolve`` says) while
its heads and MLP split.
FSDP (``train.zero.FSDP_OVERRIDES``) on and off, ZeRO-1 on and off,
microbatches, int8 moments. Tolerances: the loss rtol 1e-6; every
gradient tensor, gathered, within 1e-6 of its max|g|; first moments within
1e-6 of max|m|; int8 moments within one step of their scale; logits
within 1e-5 of max|logit| (prefill and decode; the long prefill's branch
of ``FLASH_THRESHOLD`` is in ``test_torch_lm_spmd.py``). The steps run the
smoke configs in float64 (the moments stay f32, as the optimizer keeps
them, and so do the loss's logits, as JAX casts them: that leaves about
3e-7 of max|g|): in f32 a gradient summed over the data shards in another
order alone differs by up to about 1e-6 of max|g| on these 256 tokens,
which would leave the bound no room to show a fault (the f32 step is held
against JAX's in ``test_torch_lm_sharded_step.py`` and on the card by
``chip_smoke.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401
import torch

from repro_torch import configs
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as M
from repro_torch.models import sharding as sh
from repro_torch.models import spmd
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as O
from repro_torch.train import trainer as T
from repro_torch.train.zero import FSDP_OVERRIDES

GRAD_TOL = 1e-6
LOGIT_TOL = 1e-5
ARCHS = ("granite-34b", "llama3-405b", "phi3-medium-14b", "musicgen-medium",
         "internvl2-1b")
# mesh, FSDP, ZeRO-1, microbatches
VARIANTS = {"fsdp_zero1": ((2, 4), True, True, 1),
            "tp_zero1_micro2": ((2, 4), False, True, 2),
            "fsdp_no_zero1": ((2, 4), True, False, 1),
            "half_heads": ((1, 8), False, True, 1),
            "pods": ((2, 2, 2), True, True, 1)}
# heads and MLP split three ways, the padded vocab (2,048) does not
ODD = ModelConfig("odd", 2, 96, 6, 3, 192, 256, dtype="float32")


def _mesh(shape):
    return Mesh(np.full(shape, "cpu", dtype=object),
                ("pod", "data", "model")[-len(shape):])


def _cfg(arch, dtype="float32"):
    cfg = ODD if arch == "odd" else configs.get_smoke(arch)
    return dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)


def _batch(cfg, n=8, s=32):
    b = SyntheticTokens(cfg.vocab_size, n, s, seed=1).batch_at(0)
    if cfg.input_mode == "embeds":
        b["prefix_embeds"] = np.random.default_rng(3).normal(
            size=(n, cfg.n_prefix_embeds, cfg.d_model)).astype(cfg.dtype)
    return b


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _step_errors(cfg, shape, fsdp, zero1, n_micro, opt):
    """One step sharded and on one device from the same weights: (loss
    error, worst gradient error / max|g|, worst first-moment error, the
    mesh's collectives)."""
    model = M.init(cfg, seed=0, device="cpu")
    batch = _batch(cfg)
    mesh = _mesh(shape)
    rules = FSDP_OVERRIDES if fsdp else None
    sm = spmd.shard_model(model, mesh, rules)
    loss1, g1 = T.loss_and_grads(model, batch, n_micro=n_micro)
    st1 = O.adamw_init(opt, dict(model.named_parameters()))
    O.adamw_update(opt, g1, st1, dict(model.named_parameters()))
    with sh.axis_rules(mesh, rules):
        ms = T.moment_specs(opt, sm, zero1=zero1)
        st2 = T.init_sharded_opt_state(opt, sm, zero1=zero1)
        loss2, parts = T.sharded_loss_and_grads(sm, batch, n_micro=n_micro)
        red = T.reduce_grads(sm, parts, ms)
        O.sharded_adamw_update(opt, red, st2, sm, ms)
    gerr = max(_rel(O.moment_sharded(sm, k, ms[k], red[k]).full(), g)
               for k, g in g1.items())
    if opt.quantize:
        merr = 0.0
        for k, m in st1["m"].items():
            q, s = st2["m"][k]["q"].full(), st2["m"][k]["s"].full()
            got = O._dequant(q, s, q.shape)
            want = O._dequant(m["q"], m["s"], m["q"].shape)
            # one int8 step of the scale: rounding may flip at a boundary
            step = O._dequant(torch.ones_like(q), s, q.shape)
            merr = max(merr, float(((got - want).abs() - step).max()))
    else:
        merr = max(_rel(st2["m"][k].full(), m) for k, m in st1["m"].items())
    return abs(float(loss2) / float(loss1) - 1), gerr, merr, mesh


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_one_device(arch, variant):
    shape, fsdp, zero1, n_micro = VARIANTS[variant]
    opt = O.AdamWConfig(lr=1e-3, warmup_steps=0)
    lerr, gerr, merr, mesh = _step_errors(_cfg(arch, "float64"), shape,
                                          fsdp, zero1, n_micro, opt)
    assert lerr < 1e-6 and gerr < GRAD_TOL and merr < GRAD_TOL, \
        (lerr, gerr, merr)
    coll = mesh.collectives
    assert coll["all-reduce"]["count"] > 0
    if fsdp:                # weights gathered over data, grads scattered
        assert coll["all-gather"]["count"] > 0
        assert coll["reduce-scatter"]["count"] > 0


def test_int8_moments_sharded():
    """int8 moments (``quantize``), FSDP on the (data 2, model 4) mesh:
    ZeRO-1 off (JAX's rule), JAX's blocks of each moment: the dequantized
    first moments within one quantization step of the one-device ones."""
    opt = O.AdamWConfig(lr=1e-3, warmup_steps=0, quantize=True)
    lerr, gerr, merr, _ = _step_errors(_cfg("granite-34b", "float64"),
                                       (2, 4), True, True, 1, opt)
    assert lerr < 1e-6 and gerr < GRAD_TOL and merr <= 1e-7, \
        (lerr, gerr, merr)


def test_vocab_the_axis_does_not_divide():
    """(data 2, model 3): the table and the head whole on every
    coordinate (no vocab all-reduce), heads and MLP split three ways."""
    mesh = _mesh((2, 3))
    sm = spmd.shard_model(M.init(ODD, seed=0, device="cpu"), mesh)
    assert sm.params["embed"].spec == (None, None)
    assert sm.params["unembed"].spec == (None, None)
    assert sm.params["blocks.0.mixer.wq"].spec == (None, "model")
    assert sm.params["blocks.0.ffn.w_down"].spec == ("model", None)
    opt = O.AdamWConfig(lr=1e-3, warmup_steps=0)
    lerr, gerr, merr, _ = _step_errors(_cfg("odd", "float64"), (2, 3),
                                       True, True, 1, opt)
    assert lerr < 1e-6 and gerr < GRAD_TOL and merr < GRAD_TOL


@pytest.mark.parametrize("shape", [(2, 4), (1, 8), (2, 3), (2, 2, 2)])
@pytest.mark.parametrize("arch", ARCHS + ("odd",))
def test_sharded_prefill_and_decode(arch, shape):
    """Prefill of 16 positions (the dense branch) then 3 decode steps:
    last-position logits within 1e-5 of max|logit| of one device at each
    step, under the default rules."""
    cfg = _cfg(arch)
    model = M.init(cfg, seed=0, device="cpu")
    sm = spmd.shard_model(model, _mesh(shape))
    rng = np.random.default_rng(0)
    b, s = 2, 16
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)))
    pfx, npfx = None, 0
    if cfg.input_mode == "embeds":
        npfx = cfg.n_prefix_embeds
        pfx = torch.as_tensor(rng.normal(
            size=(b, npfx, cfg.d_model)).astype(np.float32))
    alloc = npfx + s + 3
    l1, c1 = M.prefill_step(model, tok, prefix_embeds=pfx, alloc_seq=alloc,
                            cache_dtype=torch.float32)
    l2, c2 = M.prefill_step(sm, tok, prefix_embeds=pfx, alloc_seq=alloc,
                            cache_dtype=torch.float32)
    errs = [_rel(l2.full(), l1)]
    for t in range(3):
        nt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, 1)))
        l1, c1 = M.decode_step(model, nt, c1, pos=npfx + s + t)
        l2, c2 = M.decode_step(sm, nt, c2, pos=npfx + s + t)
        errs.append(_rel(l2.full(), l1))
    assert max(errs) < LOGIT_TOL, errs
    assert c2[0]["end"] == npfx + s + 3


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "mixtral-8x7b",
                                  "qwen2-moe-a2.7b", "mamba2-370m",
                                  "recurrentgemma-2b"])
def test_gather_model_and_from_jax_weights_roundtrip(arch):
    """JAX's weights (``repro.models.model.init`` of the smoke config)
    through ``convert.model_from_jax``, then ``shard_model`` under FSDP on
    a 2 x 4 mesh, then ``gather_model``: every weight bit for bit."""
    import jax
    from repro import configs as jconfigs
    from repro.models import model as jmodel
    from repro_torch import convert
    params, _ = jmodel.init(jconfigs.get_smoke(arch), jax.random.PRNGKey(2))
    model = convert.model_from_jax(configs.get_smoke(arch),
                                   jax.tree.map(np.asarray, params),
                                   device="cpu")
    sm = spmd.shard_model(model, _mesh((2, 4)), FSDP_OVERRIDES)
    spec = {"phi3-medium-14b": ("blocks.1.mixer.wo", ("model", "data")),
            "mixtral-8x7b": ("blocks.1.ffn.w_down", (None, "model", "data")),
            "qwen2-moe-a2.7b": ("blocks.1.ffn.w_gate",
                                (None, "data", "model")),
            "mamba2-370m": ("blocks.1.mixer.w_x", ("data", "model")),
            "recurrentgemma-2b": ("blocks.0.mixer.w_rg", ("model", None))}
    name, want = spec[arch]
    assert sm.params[name].spec == want
    back = spmd.gather_model(sm)
    for (k, a), (k2, b) in zip(model.named_parameters(),
                               back.named_parameters()):
        assert k == k2 and torch.equal(a, b), k


def test_refusals():
    """The MoE and recurrent families and a block-sparse FFN shard and run
    (their steps and serving are held to one device in
    ``test_torch_lm_sharded_{moe,recurrent,sparse}.py``); so do JAX's two
    serve overrides, once refused here: a context-parallel cache
    (``cache_seq``) and sequence-parallel attention (``attn_q_seq``) give
    finite logits of the expected shape (held to one device in
    ``test_torch_lm_serve_overrides.py``)."""
    mesh = _mesh((2, 4))
    for arch in ("mixtral-8x7b", "qwen2-moe-a2.7b", "mamba2-370m",
                 "recurrentgemma-2b"):
        cfg = configs.get_smoke(arch)
        sm = spmd.shard_model(M.init(cfg, seed=0, device="cpu"), mesh)
        logits = sm(torch.zeros((2, 4), dtype=torch.long))
        assert logits.full().shape == (2, 4, cfg.padded_vocab())
    sparse = dataclasses.replace(configs.get_smoke("granite-34b"),
                                 sparsity=__import__(
                                     "repro_torch.models.config",
                                     fromlist=["BlockSparsity"]
                                 ).BlockSparsity(block=16))
    sm = spmd.shard_model(M.init(sparse, seed=0, device="cpu"), mesh)
    assert set(sm.masks) == {f"blocks.{i}.ffn.mask_{w}" for i in range(2)
                             for w in ("w_gate", "w_up", "w_down")}
    assert torch.isfinite(sm(torch.zeros((2, 4), dtype=torch.long))
                          .full()).all()
    cfg = configs.get_smoke("granite-34b")
    model = M.init(cfg, seed=0, device="cpu")
    sm = spmd.shard_model(model, mesh, {"cache_seq": "model"})
    cache = sm.init_cache(2, 16)
    assert cache[0]["k"].spec == (("data",), "model", None, None)
    logits, _ = M.prefill_step(sm, torch.zeros((2, 8), dtype=torch.long),
                               alloc_seq=16)
    assert logits.full().shape == (2, cfg.padded_vocab())
    assert torch.isfinite(logits.full()).all()
    sm = spmd.shard_model(model, mesh, {"attn_q_seq": "model"})
    logits = sm(torch.zeros((2, 4), dtype=torch.long)).full()
    assert logits.shape == (2, 4, cfg.padded_vocab())
    assert torch.isfinite(logits).all()
