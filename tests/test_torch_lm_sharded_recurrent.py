"""The sharded recurrent mixers (``layers.ssd_sharded``,
``layers.rglru_sharded``) on CPU meshes against the port's one-device LM,
for mamba2-370m's and recurrentgemma-2b's smoke configs in float64, their
mixers' leaves drawn by ``_recurrent_draw`` (``d_skip`` 0: the state
alone carries the mixer's output, so a decode that lost its state, or a
conv tail that lost a channel, fails).

The SSD's caches keep JAX's specs: the conv tail's inner + 2N = 160
channels split over "model" (40 a coordinate on model 4, 20 on model 8)
while a coordinate's heads are 32 or 16 channels, so a tail shard does not
hold whole heads and the B/C channels lie on the last coordinates; the
state is whole over "model". The RG-LRU's caches split as its channels.
Tolerances: the loss rtol 1e-6, gradients and first moments within 1e-6
of max (the moments stay f32, as on one device), logits within 1e-5 of
max|logit|, and the gathered caches within 1e-12 of the one-device
caches.
"""
from __future__ import annotations

import pytest
from _threads import one_thread                          # noqa: F401
import torch
from _sharded_lm import (SHAPES, VARIANTS, batch, cfg_of, init, mesh, rel,
                         serve_errors, step_errors)

from repro_torch.models import model as M
from repro_torch.models import spmd
from repro_torch.train.zero import FSDP_OVERRIDES

TOL = 1e-6
LOGIT_TOL = 1e-5
CACHE_TOL = 1e-12
ARCHS = ("mamba2-370m", "recurrentgemma-2b")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_step_matches_one_device(arch, variant):
    shape, fsdp, zero1, n_micro = VARIANTS[variant]
    cfg = cfg_of(arch)
    lerr, gerr, merr, sm = step_errors(
        init(cfg), batch(cfg), shape, FSDP_OVERRIDES if fsdp else None,
        zero1=zero1, n_micro=n_micro)
    assert lerr < TOL and gerr < TOL and merr < TOL, (lerr, gerr, merr)
    name = ("blocks.0.mixer.w_x" if arch.startswith("mamba2") else
            "blocks.0.mixer.w_in")
    assert sm.params[name].spec[1] == "model"


@pytest.mark.parametrize("arch", ARCHS)
def test_clipping_and_int8_moments(arch):
    """Clipping on (grad_clip 0.05) with f32 moments, then int8 moments,
    FSDP on (data 2, model 4): the norm counts each shard once (first
    moments within 1e-6), and the int8 moments of the mixers' weights
    keep JAX's blocks (within one step of their scale)."""
    from repro_torch.train import optimizer as O
    cfg = cfg_of(arch)
    model, data = init(cfg), batch(cfg)
    for opt, mtol in ((O.AdamWConfig(lr=1e-3, warmup_steps=0,
                                     grad_clip=0.05), TOL),
                      (O.AdamWConfig(lr=1e-3, warmup_steps=0,
                                     quantize=True), 1e-7)):
        lerr, gerr, merr, _ = step_errors(model, data, (2, 4),
                                          FSDP_OVERRIDES, opt=opt)
        assert lerr < TOL and gerr < TOL and merr <= mtol, (lerr, gerr,
                                                            merr)


def _caches_close(c1, c2):
    for li, (a, b) in enumerate(zip(c1, c2)):
        assert a["end"] == b["end"], li
        for k, t in a.items():
            if k != "end":
                assert rel(b[k].full(), t) < CACHE_TOL, (li, k)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_prefill_and_decode(arch, shape):
    """Prefill of 16 positions then 3 decode steps, default rules: logits
    within 1e-5 of max|logit| at every step, each gathered cache within
    1e-12 of the one-device cache after the last."""
    model = init(cfg_of(arch))
    sm = spmd.shard_model(model, mesh(shape))
    errs, c1, c2 = serve_errors(model, sm)
    assert max(errs) < LOGIT_TOL, errs
    _caches_close(c1, c2)


@pytest.mark.parametrize("shape,span", [((2, 4), 40), ((1, 8), 20)])
def test_ssd_cache_keeps_jax_specs(shape, span):
    """The SSD's cache specs are JAX's: the conv tail's channels over
    "model", ``span`` a coordinate (not whole 16-channel heads: the
    shards cut them), the state whole over "model"."""
    cfg = cfg_of("mamba2-370m")
    sm = spmd.shard_model(init(cfg), mesh(shape))
    c = sm.init_cache(2, 8, torch.float64)[0]
    assert c["conv"].spec == (("data",), None, "model")
    assert c["conv"].shards[0].shape == (2 // shape[0], 3, span)
    assert span % cfg.ssm_head_dim
    assert c["state"].spec == (("data",), None, None, None)
    assert c["state"].shards[0].shape[1:] == (
        cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)


def test_ssd_prefill_from_a_cache():
    """A second prefill that starts from the first one's cache (its conv
    tail and state gathered, as a decode step gathers them), then a decode
    step, on (data 2, model 4): logits within 1e-5, caches within
    1e-12."""
    model = init(cfg_of("mamba2-370m"))
    sm = spmd.shard_model(model, mesh((2, 4)))
    g = torch.Generator().manual_seed(3)
    tok = torch.randint(0, 512, (2, 24), generator=g)
    nxt = torch.randint(0, 512, (2, 1), generator=g)
    errs, caches = [], []
    for m in (model, sm):
        _, c = M.prefill_step(m, tok[:, :10], alloc_seq=32,
                              cache_dtype=torch.float64)
        lg, c = m(tok[:, 10:], mode="prefill", cache=c, pos_offset=10)
        last, c = M.decode_step(m, nxt, c, pos=24)
        errs.append((lg, last))
        caches.append(c)
    (l1, d1), (l2, d2) = errs
    assert rel(l2.full(), l1) < LOGIT_TOL and rel(d2.full(), d1) < LOGIT_TOL
    _caches_close(*caches)


def test_ssd_span_that_cuts_a_head_raises():
    """ssm_head_dim 32 (4 heads of 128 channels) on model 8: 16 channels a
    coordinate cut a head."""
    cfg = cfg_of("mamba2-370m", ssm_head_dim=32)
    sm = spmd.shard_model(init(cfg), mesh((1, 8)))
    with pytest.raises(ValueError, match="cuts the SSD heads of "
                       "ssm_head_dim 32"):
        sm(torch.zeros((2, 4), dtype=torch.long))
