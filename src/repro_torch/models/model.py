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
  init_axes(cfg), init_cache_axes(cfg)    -> JAX's logical axes, by name
  ShardedModel (``spmd.shard_model``)     -> the same forward over a mesh;
  sharded_loss(model, batch, remat=)         prefill_step and decode_step
                                             take it too

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
from . import layers, spmd
from . import sharding as sh
from .config import ModelConfig

Caches = List[Optional[layers.Cache]]


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, kind: str, *, device=None):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        self.norm_mixer = layers._param((cfg.d_model,), cfg, device,
                                        ("embed",))
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
            self.norm_mlp = layers._param((cfg.d_model,), cfg, device,
                                          ("embed",))
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
        v, d = cfg.padded_vocab(), cfg.d_model
        self.embed = layers._param((v, d), cfg, device, ("vocab", "embed"))
        self.unembed = None if cfg.tie_embeddings else layers._param(
            (d, v), cfg, device, ("embed", "vocab"))
        self.norm_final = layers._param((d,), cfg, device, ("embed",))
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


_CACHE_AXES = {
    "attn": {"k": ("batch", "cache_seq", "kv_heads", "head_dim"),
             "v": ("batch", "cache_seq", "kv_heads", "head_dim")},
    "ssd": {"conv": ("batch", "conv_width", "ssm_inner"),
            "state": ("batch", None, None, "ssm_state")},
    "rglru": {"conv": ("batch", "conv_width", "lru_width"),
              "state": ("batch", "lru_width")},
}
_CACHE_AXES["local_attn"] = _CACHE_AXES["attn"]


def init_axes(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """JAX's logical axes of every parameter (``repro.models.model.
    init_axes``), keyed by ``named_parameters()`` name; one module a layer,
    so JAX's leading ``"layers"`` axis drops out. Built on the meta device
    (nothing allocated)."""
    return {name: p.logical_axes for name, p in
            Model(cfg, device=torch.device("meta")).named_parameters()}


def init_cache_axes(cfg: ModelConfig) -> List[Dict[str, tuple]]:
    """The logical axes of each layer's decode cache tensors (``init_cache``'s
    keys; ``"end"`` is a host int), JAX's less its ``"layers"`` axis."""
    pattern = cfg.block_pattern
    return [dict(_CACHE_AXES[pattern[i % len(pattern)]])
            for i in range(cfg.n_layers)]


# ----------------------------------------------------------------------
class ShardedModel:
    """A ``Model``'s weights placed on a device mesh (``spmd.shard_model``)
    and its forward as one SPMD program over the mesh's coordinates.

    ``params``: {name: ``spmd.Sharded``} by the specs ``rules`` resolve
    from ``init_axes`` (each shard an ``nn.Parameter`` leaf). Each
    coordinate computes on its own shards and on what collectives bring it:
    the batch splits over the rule of ``"batch"`` (data, and pod where the
    mesh has one; replicated where it does not divide), and
    ``prefix_embeds`` with it; the embedding and the logits are
    vocab-parallel where ``vocab`` is sharded (a masked lookup and an
    all-reduce; the cross-entropy from all-reduced max, sum-exp and gold
    logit), else the table is used whole; the blocks are
    ``layers.attention_sharded`` and ``layers.mlp_sharded``; a weight whose
    "embed" dim is sharded (FSDP) is all-gathered over "data" before use
    and its gradient comes back reduce-scattered by autograd. A coordinate
    computes on a whole weight only where its spec leaves it replicated.

    The dense families only: attention blocks and a dense MLP, with or
    without ``prefix_embeds``. The serve rules ``cache_seq`` and
    ``attn_q_seq`` are not executed (``init_cache`` and ``forward``
    raise)."""

    def __init__(self, cfg: ModelConfig, mesh, rules, params):
        self.check_config(cfg)
        self.cfg, self.mesh, self.rules = cfg, mesh, dict(rules)
        self.params: Dict[str, spmd.Sharded] = params

    @staticmethod
    def check_config(cfg: ModelConfig) -> None:
        what = [f"{k} blocks" for k in sorted(
            set(cfg.block_pattern) - {"attn", "local_attn"})]
        what += ["the MoE FFN"] * cfg.is_moe
        what += ["a block-sparse FFN"] * (cfg.sparsity is not None)
        if what:
            raise ValueError(
                f"{cfg.name}: the sharded forward runs attention blocks and "
                f"a dense MLP; {', '.join(what)}: not executed sharded yet "
                f"(ROADMAP queue 1)")

    def leaves(self) -> List[torch.Tensor]:
        """Every shard of every parameter, by name then coordinate."""
        return [t for p in self.params.values() for t in p.shards]

    def batch_entry(self, batch: int):
        """The spec entry the batch dim takes (``"batch"``, shape
        checked)."""
        return sh.resolve_with(self.rules, self.mesh.shape, ("batch",),
                               (batch,))[0]

    def rows(self, batch: int) -> List[slice]:
        """The batch rows each coordinate holds."""
        ent, sizes = self.batch_entry(batch), self.mesh.shape
        return [sh.shard_slice(batch, ent, sizes, c)
                for c in self.mesh.coords()[:spmd.n_coords(self.mesh)]]

    def split(self, x, batch: int) -> List[torch.Tensor]:
        """A global batch-major tensor cut into each coordinate's rows, on
        its device."""
        x = torch.as_tensor(x)
        return [x[r].to(d) for r, d in zip(self.rows(batch),
                                            self.mesh.device_list)]

    def weight(self, name: str, keep: Optional[int], act, dtype=None):
        """Per coordinate, parameter ``name`` (cast to ``dtype`` first,
        where given) with every mesh axis all-gathered but those of dim
        ``keep`` (its tensor-parallel axes, kept where they are not the
        batch's ``act``); each coordinate's (start, stop) of dim ``keep``;
        and the kept axes."""
        p = self.params[name]
        ws = [t if dtype is None else t.to(dtype) for t in p.shards]
        kept: Tuple[str, ...] = ()
        for d, entry in enumerate(p.spec):
            axes = sh.axes_of(entry)
            if not axes:
                continue
            if d == keep and set(axes).isdisjoint(act):
                kept = axes
                continue
            ws = spmd.all_gather(ws, self.mesh, axes, d)
        if keep is None:
            return ws, None, ()
        spans = [p.span(i, keep) if kept else (0, p.shape[keep])
                 for i in range(len(p.shards))]
        return ws, spans, kept

    def _embed(self, tok, act, cdt) -> List[torch.Tensor]:
        table, vspan, vax = self.weight("embed", 0, act, cdt)
        xs = []
        for t, w, (v0, v1) in zip(tok, table, vspan):
            if vax:
                loc = t - v0
                inr = (loc >= 0) & (loc < v1 - v0)
                xs.append(layers.embed_lookup(w, torch.where(inr, loc, 0)) *
                          inr[..., None].to(w.dtype))
            else:
                xs.append(layers.embed_lookup(w, t))
        xs = spmd.all_reduce(xs, self.mesh, vax)
        return [x * math.sqrt(self.cfg.d_model) for x in xs]

    def _block(self, li: int, xs, pos, *, mode: str, cache, act):
        cfg = self.cfg
        kind = cfg.block_pattern[li % len(cfg.block_pattern)]
        window = cfg.sliding_window if kind == "attn" else cfg.local_window
        pre = f"blocks.{li}."
        nw = self.weight(pre + "norm_mixer", None, act)[0]
        h = [layers.rms_norm(x, w, cfg.norm_eps) for x, w in zip(xs, nw)]
        ys, cache = layers.attention_sharded(self, li, h, pos, window=window,
                                             mode=mode, caches=cache,
                                             act=act)
        xs = [x + y for x, y in zip(xs, ys)]
        if cfg.mlp_type != "none":
            nw = self.weight(pre + "norm_mlp", None, act)[0]
            h = [layers.rms_norm(x, w, cfg.norm_eps) for x, w in zip(xs, nw)]
            xs = [x + y for x, y in zip(xs, layers.mlp_sharded(self, li, h,
                                                                act))]
        return xs, cache

    def _train_block(self, li: int, pos, act, *xs):
        return tuple(self._block(li, list(xs), pos, mode="train", cache=None,
                                 act=act)[0])

    def __call__(self, tokens, *, prefix_embeds=None, mode: str = "train",
                 cache=None, pos_offset: int = 0, remat: bool = True):
        """``Model.forward`` over the mesh: tokens (B, S) and
        ``prefix_embeds`` (B, P, d) are global (any device; each
        coordinate takes its rows). Returns the logits as an
        ``spmd.Sharded`` (B, P + S, V): batch over the batch axes, vocab
        over the model axes where the head is vocab-parallel; with
        ``cache`` (``init_cache``, updated in place) also the cache."""
        cfg = self.cfg
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"mode must be train, prefill or decode, got "
                             f"{mode!r}")
        if mode != "decode" and self.rules.get("attn_q_seq") is not None:
            raise ValueError("attn_q_seq is sharded: sequence-parallel "
                             "attention is not executed yet (ROADMAP queue "
                             "1); the dry run prices it")
        cdt = layers.torch_dtype(cfg.dtype)
        tokens = torch.as_tensor(tokens)
        bsz = tokens.shape[0]
        bent = self.batch_entry(bsz)
        act = sh.axes_of(bent)
        x = self._embed([t.long() for t in self.split(tokens, bsz)], act,
                        cdt)
        if prefix_embeds is not None:
            x = [torch.cat([p.to(cdt), xi], dim=1) for p, xi in
                 zip(self.split(prefix_embeds, bsz), x)]
        s = x[0].shape[1]
        pos = [(pos_offset + torch.arange(s, device=xi.device)).expand(
            xi.shape[0], s) for xi in x]
        ckpt = remat and mode == "train" and torch.is_grad_enabled()
        for li in range(cfg.n_layers):
            if ckpt:
                x = list(_ckpt.checkpoint(
                    functools.partial(self._train_block, li, pos, act), *x,
                    use_reentrant=False,
                    context_fn=_remat_context(cfg.remat_policy)))
            else:
                x, c = self._block(li, x, pos, mode=mode,
                                   cache=None if cache is None else cache[li],
                                   act=act)
                if cache is not None:
                    cache[li] = c
        nw = self.weight("norm_final", None, act)[0]
        x = [layers.rms_norm(xi, w, cfg.norm_eps) for xi, w in zip(x, nw)]
        if cfg.tie_embeddings:
            w, _, vax = self.weight("embed", 0, act, cdt)
            logits = [xi @ wi.T for xi, wi in zip(x, w)]
        else:
            w, _, vax = self.weight("unembed", 1, act, cdt)
            logits = [xi @ wi for xi, wi in zip(x, w)]
        if cfg.logits_soft_cap:
            c = cfg.logits_soft_cap
            logits = [c * torch.tanh(lg / c) for lg in logits]
        vent = (vax[0] if len(vax) == 1 else vax) if vax else None
        out = spmd.Sharded(self.mesh, (bent, None, vent),
                           (bsz, s, cfg.padded_vocab()), logits)
        if mode == "train":
            return out
        return out, cache

    def init_cache(self, batch: int, alloc_seq: int, dtype=torch.bfloat16):
        """``init_cache`` over the mesh: each layer's ``{"k", "v":
        spmd.Sharded, "end": int}`` by ``init_cache_axes`` (batch over the
        batch axes, kv heads over "model" where it divides). A rule that
        shards ``cache_seq`` raises: not executed yet."""
        cfg, caches = self.cfg, []
        pattern = cfg.block_pattern
        for li, axes in enumerate(init_cache_axes(cfg)):
            kind = pattern[li % len(pattern)]
            win = cfg.sliding_window if kind == "attn" else cfg.local_window
            alloc = min(alloc_seq, win) if win else alloc_seq
            shape = (batch, alloc, cfg.n_kv_heads, cfg.head_dim)
            spec = sh.resolve_with(self.rules, self.mesh.shape, axes["k"],
                                   shape)
            if spec[1] is not None or spec[3] is not None:
                raise ValueError(f"the cache spec {spec} shards its "
                                 f"positions or head dim: not executed yet "
                                 f"(ROADMAP queue 1); the dry run prices it")
            caches.append({"k": spmd.zeros(shape, dtype, self.mesh, spec),
                           "v": spmd.zeros(shape, dtype, self.mesh, spec),
                           "end": 0})
        return caches


def sharded_loss(model: ShardedModel, batch: Dict[str, object], *,
                 remat: bool = True) -> List[torch.Tensor]:
    """``loss_fn`` over the mesh: JAX's masked mean over every label >= 0
    of the global batch, its sum and its count each all-reduced over the
    batch axes (never a mean of shard means). With the head vocab-parallel,
    the log-sum-exp is the all-reduced max plus the log of the all-reduced
    sum of exponentials, and the gold logit is all-reduced from the shard
    that holds it. Returns each coordinate's copy of the loss; the
    gradient of their mean is the loss's."""
    logits = model(batch["tokens"], prefix_embeds=batch.get("prefix_embeds"),
                   mode="train", remat=remat)
    mesh = model.mesh
    labels = torch.as_tensor(batch["labels"])
    labs = [lab.long() for lab in model.split(labels, labels.shape[0])]
    lgs = [lg[:, lg.shape[1] - lab.shape[1]:, :].to(torch.float32)
           for lg, lab in zip(logits.shards, labs)]
    vax = sh.axes_of(logits.spec[2])
    if vax:
        # log-sum-exp's value (torch.logsumexp's formula, the sum over the
        # shards) as a constant, and its gradient exp(logit - lse) (torch's)
        # from the all-reduced sum of exp(logit - lse), which is 1
        with torch.no_grad():
            mx = spmd.all_reduce_max([lg.amax(-1) for lg in lgs], mesh, vax)
            se = spmd.all_reduce([torch.exp(lg - m[..., None]).sum(-1)
                                  for lg, m in zip(lgs, mx)], mesh, vax)
            lse = [torch.log(e) + m for m, e in zip(mx, se)]
        one = spmd.all_reduce([torch.exp(lg - z[..., None]).sum(-1)
                               for lg, z in zip(lgs, lse)], mesh, vax)
        logz = [z + (o - o.detach()) for z, o in zip(lse, one)]
        gold = []
        for i, (lg, lab) in enumerate(zip(lgs, labs)):
            v0, v1 = logits.span(i, 2)
            loc = lab - v0
            inr = (loc >= 0) & (loc < v1 - v0)
            g = torch.gather(lg, -1, torch.where(inr, loc, 0)[..., None])
            gold.append(torch.where(inr, g[..., 0], 0.0))
        gold = spmd.all_reduce(gold, mesh, vax)
    else:
        logz = [torch.logsumexp(lg, dim=-1) for lg in lgs]
        gold = [torch.gather(lg, -1, lab.clamp_min(0)[..., None])[..., 0]
                for lg, lab in zip(lgs, labs)]
    sums = [torch.where(lab >= 0, lz - gd, 0.0).sum()
            for lz, gd, lab in zip(logz, gold, labs)]
    counts = [(lab >= 0).sum() for lab in labs]
    act = sh.axes_of(logits.spec[0])
    sums = spmd.all_reduce(sums, mesh, act)
    counts = spmd.all_reduce(counts, mesh, act)
    return [t / torch.clamp_min(c, 1) for t, c in zip(sums, counts)]


def _last(logits):
    """The last position's logits (B, V), sharded as the logits are."""
    if isinstance(logits, spmd.Sharded):
        return spmd.Sharded(logits.mesh, (logits.spec[0], logits.spec[2]),
                            (logits.shape[0], logits.shape[2]),
                            [lg[:, -1, :] for lg in logits.shards])
    return logits[:, -1, :]


@torch.no_grad()
def prefill_step(model, tokens, *, prefix_embeds=None,
                 alloc_seq: int, cache_dtype=torch.bfloat16):
    """Run the full prompt (after ``prefix_embeds``, if given), build the
    decode cache, return last logits. ``alloc_seq`` must count the
    prefix. On a ``ShardedModel`` the logits are an ``spmd.Sharded`` (B,
    V) and the cache its ``init_cache``."""
    if isinstance(model, ShardedModel):
        cache = model.init_cache(tokens.shape[0], alloc_seq, cache_dtype)
    else:
        cache = init_cache(model.cfg, tokens.shape[0], alloc_seq,
                           cache_dtype, model.device)
    logits, cache = model(tokens, prefix_embeds=prefix_embeds,
                          mode="prefill", cache=cache)
    return _last(logits), cache


@torch.no_grad()
def decode_step(model, token, cache, *, pos: int):
    """One decode step. token: (B, 1); pos: the position of the new
    token. Returns (logits (B, V), cache), sharded on a
    ``ShardedModel``."""
    logits, cache = model(token, mode="decode", cache=cache, pos_offset=pos)
    return _last(logits), cache
