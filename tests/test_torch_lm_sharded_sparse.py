"""The block-sparse FFN (``cfg.sparsity``, JAX's mask-dense form) on CPU
meshes against the port's one-device LM, in float64: the config of
``examples/train_sparse_lm.py`` (d 128, d_ff 512, blocks of 32) with half
of each mask's blocks zeroed.

The masks are whole on every coordinate (JAX's ``(None, None)``); each
coordinate applies the blocks of its own columns of ``w_gate``/``w_up``
and rows of ``w_down``. The gradient of a zeroed block is 0 on both sides.
A shard span that cuts a block raises, naming the block size and the
span. Tolerances as ``test_torch_lm_sharded_moe.py``'s.
"""
from __future__ import annotations

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401
import torch
from _sharded_lm import (SHAPES, VARIANTS, batch, cfg_of, init, mesh,
                         serve_errors, step_errors)

from repro_torch.examples import train_sparse_lm
from repro_torch.models import spmd
from repro_torch.models.config import BlockSparsity, ModelConfig
from repro_torch.train.zero import FSDP_OVERRIDES

TOL = 1e-6
LOGIT_TOL = 1e-5


def _sparse(seed=0):
    """The example's block-sparse config in float64, half of each mask's
    blocks zeroed (not the init's all ones)."""
    cfg = cfg_of(train_sparse_lm.build("sparse-lm", 128, 2, 512, True, 32))
    model = init(cfg, seed=seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, m in model.named_buffers():
            m.copy_(torch.from_numpy(rng.random(tuple(m.shape)) < 0.5))
    return model


@pytest.mark.parametrize("variant", VARIANTS)
def test_sparse_step_matches_one_device(variant):
    shape, fsdp, zero1, n_micro = VARIANTS[variant]
    model = _sparse()
    lerr, gerr, merr, sm = step_errors(
        model, batch(model.cfg), shape, FSDP_OVERRIDES if fsdp else None,
        zero1=zero1, n_micro=n_micro)
    assert lerr < TOL and gerr < TOL and merr < TOL, (lerr, gerr, merr)
    mask = model.blocks[0].ffn.mask_w_up
    assert all(torch.equal(m, mask) for m in
               sm.masks["blocks.0.ffn.mask_w_up"])
    assert 0 < float(mask.mean()) < 1


def test_zeroed_blocks_take_no_gradient():
    """Each gathered gradient is 0 on every zeroed block."""
    from repro_torch.models import sharding as sh
    from repro_torch.train import trainer as T
    model = _sparse()
    mh = mesh((2, 4))
    sm = spmd.shard_model(model, mh, FSDP_OVERRIDES)
    with sh.axis_rules(mh, FSDP_OVERRIDES):
        _, parts = T.sharded_loss_and_grads(sm, batch(model.cfg))
    blk = model.cfg.sparsity.block
    for li in range(model.cfg.n_layers):
        for w in ("w_gate", "w_up", "w_down"):
            name = f"blocks.{li}.ffn.{w}"
            g = spmd.Sharded(mh, sm.params[name].spec, sm.params[name].shape,
                             parts[name]).full()
            m = getattr(model.blocks[li].ffn, f"mask_{w}")
            full = m.repeat_interleave(blk, 0).repeat_interleave(blk, 1)
            assert float(g[full == 0].abs().max()) == 0.0, name
            assert float(g[full == 1].abs().max()) > 0.0, name


@pytest.mark.parametrize("shape", SHAPES)
def test_sparse_prefill_and_decode(shape):
    model = _sparse(1)
    errs, _, _ = serve_errors(model, spmd.shard_model(model, mesh(shape)))
    assert max(errs) < LOGIT_TOL, errs


def test_span_that_cuts_a_block_raises():
    """d_ff 96 in blocks of 32 on model 4: 24 columns a coordinate."""
    cfg = ModelConfig("cut", 2, 64, 2, 1, 96, 256, dtype="float32",
                      sparsity=BlockSparsity(block=32))
    sm = spmd.shard_model(init(cfg), mesh((2, 4)))
    with pytest.raises(ValueError, match=r"the shard span \[0, 24\) cuts "
                       r"the sparsity blocks of 32"):
        sm(torch.zeros((2, 4), dtype=torch.long))


def test_masks_roundtrip():
    """``shard_model`` then ``gather_model`` gives back the weights and
    the zeroed masks bit for bit."""
    model = _sparse(2)
    back = spmd.gather_model(spmd.shard_model(model, mesh((2, 4)),
                                              FSDP_OVERRIDES))
    want = model.state_dict()
    assert any(k.endswith("mask_w_down") for k in want)
    for (k, a), (k2, b) in zip(want.items(), back.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
