"""Model assembly: embedding -> blocks -> norm -> logits.

The port of ``repro.models.model``: every architecture of the registry,
on token input or on ``prefix_embeds`` prepended to it (the embeds front
end: the modality stub's frame or patch embeddings). A block's mixer is
chosen by its kind in ``cfg.block_pattern``: attention (``attn``,
``local_attn``), Mamba2's SSD (``ssd``) or the RG-LRU (``rglru``); its FFN
is the dense MLP, the MoE FFN or none (``mlp_type="none"``). Each block is
pre-norm residual, x += mixer(norm(x)); x += ffn(norm(x)), and the blocks
are an ``nn.ModuleList``, one per layer (JAX stacks them per group of
``cfg.block_pattern`` and scans). Layer
``i`` is block ``i % len(cfg.block_pattern)`` of group
``i // len(cfg.block_pattern)``.

Entry points:
  init(cfg, seed=, device=)               -> Model, weights from a seed
  Model(tokens, prefix_embeds=, mode=, cache=, pos_offset=, remat=)
                                          -> logits [, cache]
  loss_fn(model, batch, remat=)           -> scalar loss (train objective)
  init_cache(cfg, batch, alloc_seq, dtype, device) -> per-layer caches
  prefill_step(model, tokens, prefix_embeds=, alloc_seq=)
                                          -> last logits, cache
  decode_step(model, token, cache, pos=)  -> logits, cache

In ``train`` mode with grad on and ``remat``, each block runs under
``torch.utils.checkpoint`` by ``cfg.remat_policy`` (JAX checkpoints its
scan body, one repetition of ``cfg.block_pattern``; a block is the smaller
unit, so a backward pass holds one block's recompute, not a whole
pattern's, and every op is recomputed once either way): ``"nothing"``
keeps only the block's input and recomputes the rest in the backward pass;
``"dots"`` also keeps the weight products (``aten.mm``/``addmm``, JAX's
``dots_with_no_batch_dims_saveable``) and recomputes the rest, the
attention's batched einsums included. In an MoE block the router and the
shared experts are unbatched products (``mm``) and are kept; the routed
experts' products are batched over the expert axis (``bmm``, JAX's
``einsum("becd,edf->becf")`` with its batch dim) and are recomputed, as
JAX's policy recomputes them. The recurrent mixers' weight products are
``mm`` and are kept; their scans (the SSD's chunk products and state
recurrence, the RG-LRU's doubling scan) are recomputed. Remat changes no
value: the recomputed forward routes as the first one did, bit for bit.

The activations run in ``cfg.dtype``, the embedding scaled by
sqrt(d_model) in that dtype (the JAX model scales by a numpy float64,
which promotes a bfloat16 model's activations to float32: ROADMAP fault
C3).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from ..kernels.ops import resolve_device
from . import layers
from .config import ModelConfig

Caches = List[Optional[layers.Cache]]


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, kind: str, *, device=None):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        pdt = layers.torch_dtype(cfg.param_dtype)
        self.norm_mixer = nn.Parameter(torch.empty(cfg.d_model, dtype=pdt,
                                                   device=device))
        if kind in ("attn", "local_attn"):
            self.mixer = layers.Attention(cfg, device=device)
        elif kind == "ssd":
            self.mixer = layers.SSD(cfg, device=device)
        elif kind == "rglru":
            self.mixer = layers.RGLRU(cfg, device=device)
        else:
            raise ValueError(f"unknown block kind {kind!r}")
        self.norm_mlp = self.ffn = None
        if cfg.mlp_type != "none":
            self.norm_mlp = nn.Parameter(torch.empty(
                cfg.d_model, dtype=pdt, device=device))
            self.ffn = (layers.MoE(cfg, device=device) if cfg.is_moe
                        else layers.MLP(cfg, device=device))

    @property
    def window(self) -> Optional[int]:
        return (self.cfg.sliding_window if self.kind == "attn"
                else self.cfg.local_window)

    def forward(self, x: torch.Tensor, pos: torch.Tensor, *, mode: str,
                cache: Optional[layers.Cache]):
        cfg = self.cfg
        h = layers.rms_norm(x, self.norm_mixer, cfg.norm_eps)
        if self.kind in ("attn", "local_attn"):
            y, new_cache = self.mixer(h, pos, window=self.window, mode=mode,
                                      cache=cache)
        else:
            y, new_cache = self.mixer(h, mode=mode, cache=cache)
        x = x + y
        if self.ffn is not None:
            h = layers.rms_norm(x, self.norm_mlp, cfg.norm_eps)
            x = x + (self.ffn(h, mode=mode) if cfg.is_moe else self.ffn(h))
        return x, new_cache


class Model(nn.Module):
    """``embed`` (V, d), ``unembed`` (d, V) unless tied, ``norm_final``
    (d,), ``blocks``; V = ``cfg.padded_vocab()``. The parameters are
    allocated, not set: ``init`` seeds them, ``convert.model_from_jax``
    copies them."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        pdt = layers.torch_dtype(cfg.param_dtype)
        v, d = cfg.padded_vocab(), cfg.d_model
        self.embed = nn.Parameter(torch.empty((v, d), dtype=pdt,
                                              device=device))
        self.unembed = None if cfg.tie_embeddings else nn.Parameter(
            torch.empty((d, v), dtype=pdt, device=device))
        self.norm_final = nn.Parameter(torch.empty(d, dtype=pdt,
                                                   device=device))
        pattern = cfg.block_pattern
        self.blocks = nn.ModuleList(
            Block(cfg, pattern[i % len(pattern)], device=device)
            for i in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens, *, prefix_embeds=None, mode: str = "train",
                cache: Optional[Caches] = None, pos_offset: int = 0,
                remat: bool = True):
        """tokens: (B, S) ints; prefix_embeds (B, P, d), optional: front-end
        embeddings prepended to the token embeddings, cast to the compute
        dtype (they take positions 0..P-1). Returns the logits (B, P + S, V) in
        ``train`` mode, else (logits, per-layer caches). ``remat`` applies
        in ``train`` mode with grad on (module docstring)."""
        cfg = self.cfg
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"mode must be train, prefill or decode, got "
                             f"{mode!r}")
        cdt = layers.torch_dtype(cfg.dtype)
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = layers.embed_lookup(self.embed, tokens).to(cdt) * \
            math.sqrt(cfg.d_model)
        if prefix_embeds is not None:
            pfx = torch.as_tensor(prefix_embeds, device=self.device)
            x = torch.cat([pfx.to(cdt), x], dim=1)
        bsz, s, _ = x.shape
        pos = (pos_offset + torch.arange(s, device=self.device)
               ).expand(bsz, s)
        new_caches: Caches = []
        if remat and mode == "train" and torch.is_grad_enabled():
            for blk in self.blocks:
                x = _ckpt.checkpoint(
                    _train_block, blk, x, pos, use_reentrant=False,
                    context_fn=_remat_context(cfg.remat_policy))
        else:
            for i, blk in enumerate(self.blocks):
                x, nc = blk(x, pos, mode=mode,
                            cache=None if cache is None else cache[i])
                new_caches.append(nc)
        x = layers.rms_norm(x, self.norm_final, cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = x @ self.embed.to(cdt).T
        else:
            logits = x @ self.unembed.to(cdt)
        if cfg.logits_soft_cap:
            c = cfg.logits_soft_cap
            logits = c * torch.tanh(logits / c)
        if mode == "train":
            return logits
        return logits, new_caches


def _train_block(blk: Block, x: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """One block in ``train`` mode: the unit remat checkpoints."""
    return blk(x, pos, mode="train", cache=None)[0]


# The weight products "dots" keeps; every other op is recomputed.
_SAVED_PRODUCTS = frozenset({torch.ops.aten.mm.default,
                             torch.ops.aten.addmm.default})


def _keep_products(ctx, op, *args, **kwargs):
    policy = _ckpt.CheckpointPolicy
    return (policy.MUST_SAVE if op in _SAVED_PRODUCTS
            else policy.PREFER_RECOMPUTE)


def _remat_context(policy: str):
    """``checkpoint``'s ``context_fn`` for ``cfg.remat_policy``."""
    if policy == "nothing":
        return _ckpt.noop_context_fn
    if policy == "dots":
        return functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                 _keep_products)
    raise ValueError(f"remat_policy must be 'nothing' or 'dots', got "
                     f"{policy!r}")


def loss_fn(model: Model, batch: Dict[str, object], *,
            remat: bool = True) -> torch.Tensor:
    """Next-token cross entropy over the token segment, the mean over
    labels >= 0 (JAX ``model.loss_fn``). batch: {"tokens": (B, S),
    "labels": (B, S), optional "prefix_embeds": (B, P, d)}, numpy or
    tensors; the prefix positions and labels < 0 carry no loss. The logits
    are taken in f32 for the log-sum-exp."""
    logits = model(batch["tokens"], prefix_embeds=batch.get("prefix_embeds"),
                   mode="train", remat=remat)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    npfx = logits.shape[1] - labels.shape[1]
    logits = logits[:, npfx:, :].to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = labels >= 0
    nll = torch.where(mask, logz - gold, 0.0)
    return nll.sum() / torch.clamp_min(mask.sum(), 1)


@torch.no_grad()
def init(cfg: ModelConfig, *, seed: int = 0, device=None) -> Model:
    """A model with weights drawn from ``seed`` on ``device`` (default
    CUDA) by each parameter's JAX init kind: the SSD's ``d_skip`` ones;
    the other vectors (the norms, ``dt_bias``, ``a_log``, ``a_param``)
    zeros; matrices (``conv_w`` included) and the MoE's 3-D expert tensors
    normal(0, 0.02)."""
    dev = resolve_device(device)
    model = Model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith(".d_skip"):
            p.fill_(1.0)
        elif p.ndim == 1:
            p.zero_()
        else:
            p.normal_(0.0, 0.02, generator=gen)
    return model


def init_cache(cfg: ModelConfig, batch: int, alloc_seq: int,
               dtype=torch.bfloat16, device=None) -> Caches:
    """One decode cache per layer, by its kind: attention blocks allocate
    min(alloc_seq, their window) slots; SSD and RG-LRU blocks hold their
    O(1) state and conv tail."""
    dev = resolve_device(device)
    caches: Caches = []
    pattern = cfg.block_pattern
    for i in range(cfg.n_layers):
        kind = pattern[i % len(pattern)]
        if kind == "ssd":
            caches.append(layers.init_ssd_cache(cfg, batch, dtype, dev))
        elif kind == "rglru":
            caches.append(layers.init_rglru_cache(cfg, batch, dtype, dev))
        else:
            win = cfg.sliding_window if kind == "attn" else cfg.local_window
            alloc = min(alloc_seq, win) if win else alloc_seq
            caches.append(layers.init_attn_cache(cfg, batch, alloc, dtype,
                                                 dev))
    return caches


@torch.no_grad()
def prefill_step(model: Model, tokens, *, prefix_embeds=None,
                 alloc_seq: int, cache_dtype=torch.bfloat16
                 ) -> Tuple[torch.Tensor, Caches]:
    """Run the full prompt (after ``prefix_embeds``, if given), build the
    decode cache, return last logits. ``alloc_seq`` must count the
    prefix."""
    cache = init_cache(model.cfg, tokens.shape[0], alloc_seq, cache_dtype,
                       model.device)
    logits, cache = model(tokens, prefix_embeds=prefix_embeds,
                          mode="prefill", cache=cache)
    return logits[:, -1, :], cache


@torch.no_grad()
def decode_step(model: Model, token, cache: Caches, *, pos: int
                ) -> Tuple[torch.Tensor, Caches]:
    """One decode step. token: (B, 1); pos: the position of the new
    token. Returns (logits (B, V), cache)."""
    logits, cache = model(token, mode="decode", cache=cache, pos_offset=pos)
    return logits[:, -1, :], cache
