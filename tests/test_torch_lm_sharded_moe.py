"""The sharded MoE FFN (``layers.moe_sharded``) on CPU meshes against the
port's one-device LM, for mixtral-8x7b's and qwen2-moe-a2.7b's smoke
configs (4 experts top 2; 8 experts top 4 and 2 shared experts), in
float64.

The meshes of ``_sharded_lm``: (data 2, model 4), (data 1, model 8) and
(pod 2, data 2, model 2); FSDP on and off, microbatches, int8 moments;
under the default rules every coordinate runs its ``expert_mlp`` span of
every expert, under the EP rule (``experts`` over "model") its experts
whole. Each coordinate routes its own batch rows, so the routes are the
one-device routes of those rows. Tolerances: the loss rtol 1e-6; each
gradient, gathered, within 1e-6 of its max|g|; first moments within 1e-6
of max|m| (the moments stay f32 and the loss's logits are cast to f32, as
on one device, which leaves about 3e-7); int8 moments within one step of
their scale; logits within 1e-5 of max|logit| through a prefill (the
capacity path) and decode steps (the dense path).
"""
from __future__ import annotations

import pytest
from _threads import one_thread                          # noqa: F401
import torch
from _sharded_lm import (SHAPES, VARIANTS, batch, cfg_of, init, mesh,
                         serve_errors, step_errors)

from repro_torch.models import model as M
from repro_torch.models import spmd
from repro_torch.train import optimizer as O
from repro_torch.train.zero import FSDP_OVERRIDES

TOL = 1e-6
LOGIT_TOL = 1e-5
ARCHS = ("mixtral-8x7b", "qwen2-moe-a2.7b")
EP = {"experts": "model"}


def _moes(model):
    return [b.ffn for b in model.blocks if b.ffn is not None]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_step_matches_one_device(arch, variant):
    shape, fsdp, zero1, n_micro = VARIANTS[variant]
    cfg = cfg_of(arch)
    lerr, gerr, merr, sm = step_errors(
        init(cfg), batch(cfg), shape, FSDP_OVERRIDES if fsdp else None,
        zero1=zero1, n_micro=n_micro)
    assert lerr < TOL and gerr < TOL and merr < TOL, (lerr, gerr, merr)
    assert sm.params["blocks.0.ffn.w_gate"].spec == (
        None, "data" if fsdp and shape[-2] > 1 else None, "model")
    assert sm.mesh.collectives["all-reduce"]["count"] > 0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_and_decode(arch, shape):
    """Prefill of 16 positions (capacity slots) then 3 decode steps (all
    experts), default rules: logits within 1e-5 of max|logit|."""
    model = init(cfg_of(arch))
    errs, c1, c2 = serve_errors(model, spmd.shard_model(model, mesh(shape)))
    assert max(errs) < LOGIT_TOL, errs
    assert c2[0]["end"] == c1[0]["end"] == 19


@pytest.mark.parametrize("fsdp", [False, True])
def test_expert_parallel_step(fsdp):
    """The EP rule on qwen2-moe's smoke config, 8 experts over model 4:
    each coordinate holds 2 experts whole (``expert_mlp`` stays whole,
    the router's experts split and are all-gathered for use), the shared
    experts still split over ``mlp``; the step held to one device."""
    cfg = cfg_of("qwen2-moe-a2.7b")
    rules = dict(EP, **(FSDP_OVERRIDES if fsdp else {}))
    lerr, gerr, merr, sm = step_errors(init(cfg), batch(cfg), (2, 4), rules)
    assert lerr < TOL and gerr < TOL and merr < TOL, (lerr, gerr, merr)
    emb = "data" if fsdp else None
    assert sm.params["blocks.0.ffn.w_gate"].spec == ("model", emb, None)
    assert sm.params["blocks.0.ffn.w_down"].spec == ("model", None, emb)
    assert sm.params["blocks.0.ffn.router"].spec == (emb, "model")
    assert sm.params["blocks.0.ffn.ws_gate"].spec == (emb, "model")
    assert sm.params["blocks.0.ffn.w_gate"].shards[5].shape[0] == 2


def test_expert_parallel_prefill_and_decode():
    model = init(cfg_of("qwen2-moe-a2.7b"))
    sm = spmd.shard_model(model, mesh((2, 4)), EP)
    errs, _, _ = serve_errors(model, sm)
    assert max(errs) < LOGIT_TOL, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_clipping_norm_counts_each_shard_once(arch):
    """Clipping on (grad_clip 0.05, under the norm), FSDP and the EP rule
    together: the norm counts each shard of the 3-D expert weights once,
    so the first moments (the clipped gradients) stay within 1e-6."""
    cfg = cfg_of(arch)
    opt = O.AdamWConfig(lr=1e-3, warmup_steps=0, grad_clip=0.05)
    lerr, gerr, merr, _ = step_errors(init(cfg), batch(cfg), (2, 4),
                                      dict(EP, **FSDP_OVERRIDES), opt=opt)
    assert lerr < TOL and gerr < TOL and merr < TOL, (lerr, gerr, merr)


def test_int8_moments_on_expert_weights():
    """int8 moments with FSDP on (data 2, model 4): the 3-D expert
    weights' moments quantize JAX's blocks along their last dim (a row's
    one scale, cut by a shard, its maxima all-reduced), within one step of
    their scale of the one-device moments."""
    cfg = cfg_of("mixtral-8x7b")
    opt = O.AdamWConfig(lr=1e-3, warmup_steps=0, quantize=True)
    lerr, gerr, merr, _ = step_errors(init(cfg), batch(cfg), (2, 4),
                                      FSDP_OVERRIDES, opt=opt)
    assert lerr < TOL and gerr < TOL and merr <= 1e-7, (lerr, gerr, merr)


@pytest.mark.parametrize("arch", ARCHS)
def test_routes_logged_once_and_held(arch):
    """A sharded loss under remat logs each MoE layer's routes once (the
    recompute does not log again); joined over the batch they are the
    one-device routes, and a one-device model given them as
    ``held_route`` computes the loss it computes unheld, bit for bit."""
    cfg = cfg_of(arch)
    model, data = init(cfg), batch(cfg)
    sm = spmd.shard_model(model, mesh((2, 4)), FSDP_OVERRIDES)
    sm.route_log = []
    loss = M.sharded_loss(sm, data, remat=True)[0]
    loss.backward()
    assert [li for li, _ in sm.route_log] == list(range(cfg.n_layers))
    joined = dict(sm.joined_routes(8))
    moes = _moes(model)
    for m in moes:
        m.route_log = []
    want = M.loss_fn(model, data, remat=False)
    for li, m in enumerate(moes):
        (r,) = m.route_log
        got = joined[li]
        assert torch.equal(got.topi, r.topi)
        assert torch.equal(got.rows, r.rows)
        assert torch.equal(got.valid, r.valid)
        m.route_log, m.held_route = None, got
    held = M.loss_fn(model, data, remat=False)
    # the loss is taken in f32 (as on one device)
    assert torch.equal(held, want)
    assert abs(float(loss.detach()) / float(want.detach()) - 1) < TOL
