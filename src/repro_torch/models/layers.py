"""Layers of the LM stack: RMS norm, rotary embedding, GQA attention, the
dense MLP and the MoE FFN.

The port of ``repro.models.layers`` for attention models (the SSD and
RG-LRU mixers are ROADMAP queue 1 item 12b). Parameters
live in ``cfg.param_dtype`` and are cast to the activations' dtype at use,
as in JAX. ``Attention`` has the JAX layer's three modes: ``train`` (the
full sequence, no cache), ``prefill`` (the full sequence, filling the decode
cache) and ``decode`` (one token against the cache, a ring buffer when the
window is shorter than the allocation). A prefill of ``FLASH_THRESHOLD``
tokens or more runs ``ops.flash_mha``, the flash kernel; below it the
scores are formed in torch, as JAX forms them outside any Pallas kernel.
Train mode at ``FLASH_THRESHOLD`` tokens or more runs ``_flash_attention``,
the JAX layer's chunked online-softmax attention in torch ops, on every
device: it is differentiable, and the flash kernel has no backward (JAX
never trains through its Pallas kernel either; ROADMAP queue 3, P5).

``MoE`` is JAX's ``layers.moe`` branch for branch: top-k routing (ties to
the lower expert index, as ``jax.lax.top_k``), a capacity-limited gather
dispatch per sequence in ``train`` and ``prefill``, all experts densely in
``decode`` or when S <= k, and qwen2's shared experts. Its expert products
are batched over the expert axis (``torch.bmm``; JAX computes them with
jnp outside any Pallas kernel). The gather and the combine add in
ascending expert order, one add a row an expert, so forward and backward
are the same bits on every run.

The decode cache is a dict ``{"k", "v": (B, alloc, KV, hd), "end": int}``
updated in place (JAX returns a new one), which saves a copy of every
layer's K and V per token. One device: the JAX layer's sharding
annotations have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from .config import ModelConfig

# Sequences of at least this many tokens take the chunked attention (the
# JAX layer's switch): a prefill the flash kernel, train mode
# ``_flash_attention``; FLASH_CHUNK is the key chunk (``cfg.flash_chunk``
# in the model).
FLASH_THRESHOLD = 8192
FLASH_CHUNK = 1024
NEG_INF = -1e30

Cache = Dict[str, object]


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16``, and so on."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.to(torch.float32))).to(dt)


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding; x: (..., S, H, hd), pos: (..., S)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = pos[..., :, None, None].to(torch.float32) * freq
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def _soft_cap(logits: torch.Tensor, cap) -> torch.Tensor:
    return cap * torch.tanh(logits / cap) if cap else logits


def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     qpos: torch.Tensor, kpos: torch.Tensor, *, window,
                     soft_cap, chunk: int = FLASH_CHUNK) -> torch.Tensor:
    """Grouped-query attention by an online softmax over key chunks, in
    torch ops, so autograd differentiates it (JAX
    ``layers._flash_attention``). q: (B, Sq, KV, G, hd); k/v: (B, Sk, KV,
    hd), KV heads never repeated; qpos (B, Sq), kpos (B, Sk) absolute
    positions (negative = invalid). Returns (B, Sq, KV, G, hd) in
    ``q.dtype``. The (Sq, Sk) scores are never formed whole in the forward
    pass; autograd keeps each chunk's for the backward."""
    bsz, sq, kvh, g, hd = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    nchunks = -(-sk // chunk)
    pad = nchunks * chunk - sk
    k = F.pad(k, (0, 0, 0, 0, 0, pad))
    v = F.pad(v, (0, 0, 0, 0, 0, pad))
    kpos = F.pad(kpos, (0, pad), value=-1)
    qf = q.to(torch.float32)
    qp = qpos[:, None, None, :, None]
    m = torch.full((bsz, kvh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((bsz, kvh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bsz, kvh, g, sq, hd), dtype=torch.float32,
                      device=q.device)
    for c in range(nchunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        kb, vb, pb = k[:, sl], v[:, sl], kpos[:, None, None, None, sl]
        logits = torch.einsum("bqkgd,bskd->bkgqs", qf,
                              kb.to(torch.float32)) * scale
        logits = _soft_cap(logits, soft_cap)
        valid = (pb <= qp) & (pb >= 0)
        if window is not None:
            valid = valid & (pb > qp - window)
        logits = torch.where(valid, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(logits - m_new[..., None]), 0.0)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p, vb.to(torch.float32))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def _param(shape, cfg: ModelConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch_dtype(cfg.param_dtype),
                                    device=device))


# ======================================================================
class Attention(nn.Module):
    """GQA attention (full causal or sliding window, optional soft cap):
    ``wq`` (d, H*hd), ``wk``/``wv`` (d, KV*hd), ``wo`` (H*hd, d)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.head_dim
        q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        self.wq = _param((d, q), cfg, device)
        self.wk = _param((d, kv), cfg, device)
        self.wv = _param((d, kv), cfg, device)
        self.wo = _param((q, d), cfg, device)

    def forward(self, x: torch.Tensor, pos: torch.Tensor, *,
                window: Optional[int], mode: str,
                cache: Optional[Cache] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """x: (B, S, d); pos: (B, S) absolute positions. Returns the output
        and the cache (None in ``train`` mode)."""
        cfg = self.cfg
        bsz, s, _ = x.shape
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = x.dtype
        q = (x @ self.wq.to(dt)).view(bsz, s, h, hd)
        k = (x @ self.wk.to(dt)).view(bsz, s, kv, hd)
        v = (x @ self.wv.to(dt)).view(bsz, s, kv, hd)
        q = _rope(q, pos, cfg.rope_theta)
        k = _rope(k, pos, cfg.rope_theta)
        qg = q.view(bsz, s, kv, h // kv, hd)

        new_cache = None
        if mode == "decode":
            if cache is None or s != 1:
                raise ValueError("decode mode needs a cache and a "
                                 "single-token step")
            end = int(cache["end"])                 # tokens already cached
            ck, cv = cache["k"], cache["v"]
            s_alloc = ck.shape[1]
            wpos = end % s_alloc                    # ring-buffer write slot
            ck[:, wpos] = k[:, 0].to(ck.dtype)
            cv[:, wpos] = v[:, 0].to(cv.dtype)
            cache["end"] = end + 1
            new_cache = cache
            # absolute position of each slot (ring semantics)
            slot = torch.arange(s_alloc, device=x.device)
            abs_pos = torch.where(slot <= wpos, slot + (end - wpos),
                                  slot + (end - wpos) - s_alloc)
            valid = (abs_pos >= 0) & (abs_pos <= end)
            if window is not None:
                valid &= abs_pos > end - window
            logits = torch.einsum("bqkgd,bskd->bkgqs", qg,
                                  ck.to(dt)) / math.sqrt(hd)
            logits = _soft_cap(logits, cfg.logits_soft_cap)
            logits = torch.where(valid, logits, NEG_INF)
            att = torch.softmax(logits.to(torch.float32), dim=-1).to(dt)
            yg = torch.einsum("bkgqs,bskd->bqkgd", att, cv.to(dt))
        else:
            if mode == "prefill":
                if cache is not None:
                    # the last min(S, alloc) keys go into the ring buffer
                    alloc = cache["k"].shape[1]
                    ln = min(s, alloc)
                    slots = torch.arange(s - ln, s, device=x.device) % alloc
                    cache["k"][:, slots] = k[:, -ln:].to(cache["k"].dtype)
                    cache["v"][:, slots] = v[:, -ln:].to(cache["v"].dtype)
                    cache["end"] = s
                    new_cache = cache
                else:
                    new_cache = {"k": k, "v": v, "end": s}
            if s >= FLASH_THRESHOLD and mode == "train":
                # differentiable chunked attention: the kernel has no
                # backward
                yg = _flash_attention(qg, k, v, pos, pos, window=window,
                                      soft_cap=cfg.logits_soft_cap,
                                      chunk=cfg.flash_chunk)
            elif s >= FLASH_THRESHOLD:
                # the flash kernel: no (S x S) scores in memory
                yg = ops.flash_mha(qg, k, v, window=window,
                                   soft_cap=cfg.logits_soft_cap,
                                   bk=cfg.flash_chunk)
            else:
                logits = torch.einsum("bqkgd,bskd->bkgqs", qg,
                                      k) / math.sqrt(hd)
                logits = _soft_cap(logits, cfg.logits_soft_cap)
                qp, kp = pos[:, :, None], pos[:, None, :]
                mask = kp <= qp                          # causal
                if window is not None:
                    mask &= kp > qp - window
                logits = torch.where(mask[:, None, None], logits, NEG_INF)
                att = torch.softmax(logits.to(torch.float32),
                                    dim=-1).to(dt)
                yg = torch.einsum("bkgqs,bskd->bqkgd", att, v)
        y = yg.reshape(bsz, s, h * hd)
        return y @ self.wo.to(dt), new_cache


def init_attn_cache(cfg: ModelConfig, batch: int, alloc: int,
                    dtype=torch.bfloat16, device=None) -> Cache:
    kvshape = (batch, alloc, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(kvshape, dtype=dtype, device=device),
            "v": torch.zeros(kvshape, dtype=dtype, device=device),
            "end": 0}


# ======================================================================
def _maybe_sparse_mm(x: torch.Tensor, w: torch.Tensor,
                     mask: Optional[torch.Tensor], block: int
                     ) -> torch.Tensor:
    """x @ (w ⊙ blockmask), the JAX layer's mask-dense form."""
    if mask is None:
        return x @ w
    mfull = mask.to(w.dtype).repeat_interleave(block, 0) \
        .repeat_interleave(block, 1)
    return x @ (w * mfull)


class MLP(nn.Module):
    """SwiGLU (``w_gate``, ``w_up``, ``w_down``) or GELU (``w_up``,
    ``w_down``). With ``cfg.sparsity`` the block-occupancy masks are
    buffers (``mask_w_*``, ones at init): fixed pruning metadata, not
    parameters."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.d_model, cfg.d_ff
        shapes = {"w_up": (d, f), "w_down": (f, d)}
        if cfg.mlp_type == "swiglu":
            shapes = {"w_gate": (d, f), **shapes}
        for name, shape in shapes.items():
            setattr(self, name, _param(shape, cfg, device))
        self.block = cfg.sparsity.block if cfg.sparsity else 0
        for name, (r, c) in shapes.items():
            self.register_buffer(
                f"mask_{name}",
                None if cfg.sparsity is None else torch.ones(
                    (r // self.block, c // self.block),
                    dtype=torch_dtype(cfg.param_dtype), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if self.cfg.mlp_type == "swiglu":
            g = _maybe_sparse_mm(x, self.w_gate.to(dt), self.mask_w_gate,
                                 self.block)
            u = _maybe_sparse_mm(x, self.w_up.to(dt), self.mask_w_up,
                                 self.block)
            hdn = F.silu(g) * u
        else:
            u = _maybe_sparse_mm(x, self.w_up.to(dt), self.mask_w_up,
                                 self.block)
            hdn = F.gelu(u, approximate="tanh")     # jax.nn.gelu's default
        return _maybe_sparse_mm(hdn, self.w_down.to(dt), self.mask_w_down,
                                self.block)


# ======================================================================
# MoE FFN. Routing metadata is prefix-counter style: an expert's slots are
# its assigned tokens in sequence order ("how many assigned tokens precede
# me", the InCRS counter question at token scale), then the unassigned
# ones, which carry weight 0.
@dataclasses.dataclass
class Route:
    """The routing of one ``MoE`` call. ``topi`` (B, S, k): each token's
    experts, best first. The capacity path adds ``rows`` (E, B*C): the
    flat token row (``b * S + s``) of each of an expert's C slots per
    sequence, and ``valid`` (E, B*C): whether the slot holds a token routed
    there (else its weight is 0). The dense path has neither."""
    topi: torch.Tensor
    rows: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        """Slots an expert has per sequence (0 on the dense path)."""
        if self.rows is None:
            return 0
        return self.rows.shape[1] // self.topi.shape[0]

    def dropped(self) -> int:
        """(token, expert) assignments that found no slot."""
        if self.valid is None:
            return 0
        return int(self.topi.numel() - int(self.valid.sum()))


def top_k_lower(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The k largest of the last dim, largest first, ties to the lower
    index (``jax.lax.top_k``'s order; ``torch.topk`` breaks ties
    otherwise): a stable descending sort, kept to its first k."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(s: int, cfg: ModelConfig) -> int:
    """Slots per expert and sequence: ceil(s * k * capacity_factor / E),
    at least 1 and at most s (JAX's rule; s counts any prefix)."""
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    return min(s, max(1, math.ceil(s * k * cfg.capacity_factor / e)))


def moe_route(logits: torch.Tensor, cfg: ModelConfig, *,
              dense: bool) -> Route:
    """The routing of router ``logits`` (B, S, E): the top k experts
    of each token and, unless ``dense``, each expert's capacity slots
    (assigned tokens first, in sequence order, as JAX ranks them)."""
    bsz, s, e = logits.shape
    _, topi = top_k_lower(logits, cfg.n_experts_per_tok)
    if dense:
        return Route(topi)
    cap = moe_capacity(s, cfg)
    mask = torch.zeros((bsz, s, e), dtype=torch.bool, device=logits.device)
    mask.scatter_(-1, topi, True)
    iota = torch.arange(s, device=logits.device)[None, :, None]
    prio = torch.where(mask, iota, s + iota).transpose(1, 2)   # (B, E, S)
    # priorities are distinct: the cap smallest, ascending
    prio, idx = torch.sort(prio, dim=-1)
    prio, idx = prio[..., :cap], idx[..., :cap]                # (B, E, C)
    base = (torch.arange(bsz, device=logits.device) * s)[:, None, None]
    rows = (idx + base).permute(1, 0, 2).reshape(e, bsz * cap)
    valid = (prio < s).permute(1, 0, 2).reshape(e, bsz * cap)
    return Route(topi, rows, valid)


class _Dispatch(torch.autograd.Function):
    """xg[e] = x[rows[e]]: each expert's slot rows. The backward adds the
    slots' grads into their tokens one expert at a time, in ascending
    order (an expert's rows are distinct, so one add a row an expert):
    the same bits on every run, where a scatter over colliding rows
    would add in whatever order the device's atomics land."""

    @staticmethod
    def forward(ctx, x, rows):
        ctx.save_for_backward(rows)
        ctx.n = x.shape[0]
        return x[rows]

    @staticmethod
    def backward(ctx, g):
        rows, = ctx.saved_tensors
        dx = g.new_zeros((ctx.n, g.shape[-1]))
        for e in range(rows.shape[0]):
            dx.index_add_(0, rows[e], g[e])
        return dx, None


class _Combine(torch.autograd.Function):
    """out = zeros (N, d) f32, then out[rows[e]] += y[e] for e ascending
    (JAX's ``out.at[bidx, idx].add(y)`` in its update order): a token
    routed to several experts sums their outputs in expert order, the
    same bits on every run. The backward gathers."""

    @staticmethod
    def forward(ctx, y, rows, n):
        ctx.save_for_backward(rows)
        out = y.new_zeros((n, y.shape[-1]))
        for e in range(rows.shape[0]):
            out.index_add_(0, rows[e], y[e])
        return out

    @staticmethod
    def backward(ctx, g):
        rows, = ctx.saved_tensors
        return g[rows], None, None


class MoE(nn.Module):
    """Top-k routed FFN (JAX ``layers.moe``): ``router`` (d, E),
    ``w_gate``/``w_up`` (E, d, f), ``w_down`` (E, f, d); with
    ``cfg.n_shared_experts`` also the always-on ``ws_gate``/``ws_up``
    (d, fs) and ``ws_down`` (fs, d), fs = n_shared_experts * f.

    ``route_log``, when a list, gets each call's ``Route``;
    ``held_route``, when set, replaces the router's choice (a float64
    oracle takes the routing of the run it checks, so that a near-tie
    that flips is not read as a numeric error). The expert weights are
    still applied by the router's softmax over the held experts."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        self.router = _param((d, e), cfg, device)
        self.w_gate = _param((e, d, f), cfg, device)
        self.w_up = _param((e, d, f), cfg, device)
        self.w_down = _param((e, f, d), cfg, device)
        if cfg.n_shared_experts:
            fs = cfg.n_shared_experts * f
            self.ws_gate = _param((d, fs), cfg, device)
            self.ws_up = _param((d, fs), cfg, device)
            self.ws_down = _param((fs, d), cfg, device)
        self.route_log: Optional[List[Route]] = None
        self.held_route: Optional[Route] = None

    def forward(self, x: torch.Tensor, *, mode: str) -> torch.Tensor:
        """x: (B, S, d) in the compute dtype; S counts any prefix. The
        router's logits, the combine and the dense path's weighting run
        in f32 (in f64 for an f64 model, an oracle's)."""
        cfg = self.cfg
        bsz, s, d = x.shape
        dt = x.dtype
        acc = torch.promote_types(dt, torch.float32)
        logits = (x @ self.router.to(dt)).to(acc)               # (B, S, E)
        dense = mode == "decode" or s <= cfg.n_experts_per_tok
        route = self.held_route
        if route is None:
            route = moe_route(logits.detach(), cfg, dense=dense)
        if self.route_log is not None:
            self.route_log.append(route)
        topw = torch.softmax(torch.gather(logits, -1, route.topi), dim=-1)
        wse = torch.zeros_like(logits).scatter(-1, route.topi, topw)
        if dense:
            # all experts on every token, weighted by the routed ones
            xe = x.reshape(1, bsz * s, d)
            g = torch.matmul(xe, self.w_gate.to(dt))           # (E, BS, f)
            u = torch.matmul(xe, self.w_up.to(dt))
            y = torch.bmm(F.silu(g) * u, self.w_down.to(dt))  # (E, BS, d)
            out = torch.einsum("end,ne->nd", y.to(acc),
                               wse.reshape(bsz * s, -1))
        else:
            xg = _Dispatch.apply(x.reshape(bsz * s, d), route.rows)
            g = torch.bmm(xg, self.w_gate.to(dt))              # (E, BC, f)
            u = torch.bmm(xg, self.w_up.to(dt))
            y = torch.bmm(F.silu(g) * u, self.w_down.to(dt))   # (E, BC, d)
            wg = torch.gather(wse.reshape(bsz * s, -1).t(), 1, route.rows)
            y = y * (wg * route.valid)[..., None].to(dt)
            out = _Combine.apply(y.to(acc), route.rows, bsz * s)
        return self._shared(x, out.to(dt).reshape(bsz, s, d))

    def _shared(self, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        if not self.cfg.n_shared_experts:
            return out
        dt = x.dtype
        gs = x @ self.ws_gate.to(dt)
        us = x @ self.ws_up.to(dt)
        return out + (F.silu(gs) * us) @ self.ws_down.to(dt)
