"""AdamW with optional int8-quantized moments, as plain functions.

The port of ``repro.train.optimizer``. Parameters, gradients and moments
are mappings from a name to a tensor (``dict(model.named_parameters())``
and the matching gradients); the update runs under ``torch.no_grad()``
and writes each parameter in place. The state is

  {"m": {name: m}, "v": {name: v}, "count": 0-d int32 tensor}

with f32 moments, or with ``quantize=True`` blockwise-int8 moments
``{"q": int8 payload of the parameter's shape, "s": f32 scales}`` (v is
stored in the square-root domain), which ``adamw_update`` updates in
place. Names with a part (between dots) starting ``mask_`` or ``norm``
take no weight decay. The arithmetic is
the JAX package's, in f32, step for step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Tuple

import torch

QBLOCK = 256        # quantization block (per flattened chunk)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize: bool = False       # int8 moments
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac (f32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


# ----------------------------------------------------------------------
# int8 moments. The payload keeps the parameter's exact shape; scales are
# blockwise along the last dim when it divides QBLOCK, else per row.
def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    last = x.shape[-1] if x.ndim else 1
    if x.ndim and last % QBLOCK == 0:
        xb = x.reshape(*x.shape[:-1], last // QBLOCK, QBLOCK)
        scale = xb.abs().amax(dim=-1) / 127.0 + 1e-12
        q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127)
        q = q.reshape(x.shape).to(torch.int8)
    else:
        scale = (x.abs().amax(dim=-1, keepdim=True) if x.ndim
                 else x.abs()) / 127.0 + 1e-12
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequant(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    shape = tuple(shape)
    last = shape[-1] if len(shape) else 1
    if len(shape) and last % QBLOCK == 0 and \
            scale.shape[-1] == last // QBLOCK:
        qb = q.to(torch.float32).reshape(*shape[:-1], last // QBLOCK,
                                         QBLOCK)
        return (qb * scale[..., None]).reshape(shape)
    return q.to(torch.float32) * scale


# ----------------------------------------------------------------------
def _decays(name: str) -> bool:
    """No weight decay on pruning masks (fixed metadata) or norm scales."""
    return not any(part.startswith(("mask_", "norm"))
                   for part in name.split("."))


def adamw_init(cfg: AdamWConfig,
               params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Zero moments for every named parameter, on its device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def moment(p):
        if cfg.quantize:
            q, s = _quant(zeros(p))
            return {"q": q, "s": s}
        return zeros(p)
    device = next(iter(params.values())).device if params else "cpu"
    return {"m": {k: moment(p) for k, p in params.items()},
            "v": {k: moment(p) for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in tensors.values()))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor],
                 state: Dict[str, Any],
                 params: Mapping[str, torch.Tensor]):
    """One AdamW step, in place: writes each parameter and updates
    ``state`` (f32 moments in their tensors, int8 ones replaced entry by
    entry, the count), so the old and the new moments never exist whole
    at once. Returns ``(params, state, metrics)`` with metrics
    ``grad_norm`` and ``lr``."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, state["count"])
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, count.to(torch.float32))
    bc2 = 1 - torch.pow(b2, count.to(torch.float32))
    for name, p in params.items():
        g = grads[name].to(torch.float32) * clip
        m, v = state["m"][name], state["v"][name]
        if cfg.quantize:
            mf = _dequant(m["q"], m["s"], g.shape)
            # v is stored in the sqrt domain (halves the dynamic range a
            # linear int8 grid must cover)
            vf = torch.square(_dequant(v["q"], v["s"], g.shape))
        else:
            mf, vf = m, v
        mf.mul_(b1).add_((1 - b1) * g)
        vf.mul_(b2).add_((1 - b2) * g * g)
        mhat = mf / bc1
        vhat = vf / bc2
        upd = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.quantize:
            # quantization can zero tiny v entries, which would turn
            # |m / eps| into a 1e8x step
            upd = torch.clamp(upd, -3.0, 3.0)
        wd = cfg.weight_decay if _decays(name) else 0.0
        step = upd + wd * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * step).to(p.dtype))
        if cfg.quantize:
            mq, ms = _quant(mf)
            vq, vs = _quant(torch.sqrt(vf))
            state["m"][name] = {"q": mq, "s": ms}
            state["v"][name] = {"q": vq, "s": vs}
        # this parameter's temporaries go before the next one's are made
        del g, mf, vf, mhat, vhat, upd, step
    state["count"] = count
    return params, state, {"grad_norm": gnorm, "lr": lr}
