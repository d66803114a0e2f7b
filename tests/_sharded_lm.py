"""What the sharded-LM tests of every family share: CPU meshes, weights
whose recurrent state carries the output, and one sharded train step or
serve run held to the port's one-device run from the same weights.

``from _sharded_lm import ...`` (numpy and torch only: the card tests,
which import no JAX, use it too).
"""
import dataclasses

import numpy as np
import torch
from _recurrent_draw import MIXER_LEAVES, draw_mixer_leaf

from repro_torch import configs
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as M
from repro_torch.models import sharding as sh
from repro_torch.models import spmd
from repro_torch.train import optimizer as O
from repro_torch.train import trainer as T

# mesh, FSDP, ZeRO-1, microbatches
VARIANTS = {"fsdp_zero1": ((2, 4), True, True, 1),
            "tp_zero1_micro2": ((2, 4), False, True, 2),
            "half_heads": ((1, 8), False, True, 1),
            "pods": ((2, 2, 2), True, True, 1)}
SHAPES = [(2, 4), (1, 8), (2, 2, 2)]


def mesh(shape, device="cpu"):
    return Mesh(np.full(shape, device, dtype=object),
                ("pod", "data", "model")[-len(shape):])


def rel(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def cfg_of(arch, dtype="float64", **over):
    cfg = configs.get_smoke(arch) if isinstance(arch, str) else arch
    return dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype, **over)


@torch.no_grad()
def init(cfg, seed=0, device="cpu"):
    """``model.init`` with every SSD and RG-LRU leaf redrawn by
    ``draw_mixer_leaf`` (``d_skip`` 0: the state alone carries the
    mixer's output)."""
    model = M.init(cfg, seed=seed, device=device)
    rng = np.random.default_rng(seed + 100)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if ".mixer." in name and leaf in MIXER_LEAVES:
            p.copy_(torch.from_numpy(draw_mixer_leaf(
                leaf, tuple(p.shape), rng, d_skip=0.0)))
    return model


def batch(cfg, n=8, s=32):
    return SyntheticTokens(cfg.vocab_size, n, s, seed=1).batch_at(0)


def step_errors(model, data, shape, rules=None, *, zero1=True, n_micro=1,
                opt=None, remat=True, device="cpu"):
    """One AdamW step sharded and on one device from ``model``'s weights:
    (loss error, worst gradient error / max|g|, worst first-moment error
    / max|m|, the sharded model)."""
    opt = opt or O.AdamWConfig(lr=1e-3, warmup_steps=0)
    mh = mesh(shape, device)
    sm = spmd.shard_model(model, mh, rules)
    loss1, g1 = T.loss_and_grads(model, data, n_micro=n_micro, remat=remat)
    st1 = O.adamw_init(opt, dict(model.named_parameters()))
    O.adamw_update(opt, g1, st1, dict(model.named_parameters()))
    with sh.axis_rules(mh, rules):
        ms = T.moment_specs(opt, sm, zero1=zero1)
        st2 = T.init_sharded_opt_state(opt, sm, zero1=zero1)
        loss2, parts = T.sharded_loss_and_grads(sm, data, n_micro=n_micro,
                                                remat=remat)
        red = T.reduce_grads(sm, parts, ms)
        O.sharded_adamw_update(opt, red, st2, sm, ms)
    gerr = max(rel(O.moment_sharded(sm, k, ms[k], red[k]).full(), g)
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
        merr = max(rel(st2["m"][k].full(), m) for k, m in st1["m"].items())
    return abs(float(loss2) / float(loss1) - 1), gerr, merr, sm


def serve_errors(model, sm, *, b=2, s=16, steps=3, seed=0, dtype=None):
    """A prefill of ``s`` positions then ``steps`` decode steps on the
    one-device ``model`` and on ``sm``: the last-position logits' error /
    max|logit| at each, and both caches."""
    cfg = model.cfg
    dtype = dtype or getattr(torch, cfg.dtype)
    rng = np.random.default_rng(seed)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)))
    alloc = s + steps
    l1, c1 = M.prefill_step(model, tok, alloc_seq=alloc, cache_dtype=dtype)
    l2, c2 = M.prefill_step(sm, tok, alloc_seq=alloc, cache_dtype=dtype)
    errs = [rel(l2.full(), l1)]
    for t in range(steps):
        nt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, 1)))
        l1, c1 = M.decode_step(model, nt, c1, pos=s + t)
        l2, c2 = M.decode_step(sm, nt, c2, pos=s + t)
        errs.append(rel(l2.full(), l1))
    return errs, c1, c2
