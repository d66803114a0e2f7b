"""Layers of the LM stack: RMS norm, rotary embedding, GQA attention, the
dense MLP, the MoE FFN and the two recurrent mixers, Mamba2's SSD and
RecurrentGemma's RG-LRU.

The port of ``repro.models.layers``. Parameters
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

``SSD`` and ``RGLRU`` are JAX's ``layers.ssd`` and ``layers.rglru`` branch
for branch, their recurrences in f32 (f64 in an f64 model). The SSD's
chunked form masks its intra-chunk decay inside the exponent,
``exp(where(tri, li, -inf))``: the same forward as JAX's ``where(tri,
exp(li), 0)``, whose upper triangle overflows to inf at a chunk of 256 and
gives NaN gradients (ROADMAP queue 3, C5). Its 4-operand products are
explicit batched matmuls, so no (B, C, Q, Q, H) einsum intermediate is
contracted in an unplanned order. The RG-LRU solves h_t = a_t h_{t-1} + b_t
by a doubling scan, ceil(log2 S) steps of torch ops that autograd
differentiates (JAX: ``jax.lax.associative_scan``).

The attention decode cache is a dict ``{"k", "v": (B, alloc, KV, hd),
"end": int}`` updated in place (JAX returns a new one), which saves a copy
of every layer's K and V per token. The recurrent caches ``{"conv": (B,
W-1, C), "state", "end": int}`` are updated in place too; their size does
not grow with the position.

Every parameter carries JAX's logical axes (``_param``'s ``axes``, read
by ``model.init_axes``). Over a device mesh, ``attention_sharded`` and
``mlp_sharded`` are the dense block's sharded forward (the activations'
constraints of the JAX layer become the placement ``models.spmd`` gives
each coordinate's tensors): column-parallel projections, whole heads a
coordinate, row-parallel outputs and their all-reduce.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from . import spmd
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


def _param(shape, cfg: ModelConfig, device, axes) -> nn.Parameter:
    """An allocated parameter carrying JAX's logical axes of it
    (``logical_axes``, one name or None a dim; ``model.init_axes``)."""
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} do not name the {len(shape)} dims "
                         f"of {shape}")
    p = nn.Parameter(torch.empty(shape, dtype=torch_dtype(cfg.param_dtype),
                                 device=device))
    p.logical_axes = tuple(axes)
    return p


# ======================================================================
class Attention(nn.Module):
    """GQA attention (full causal or sliding window, optional soft cap):
    ``wq`` (d, H*hd), ``wk``/``wv`` (d, KV*hd), ``wo`` (H*hd, d)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.head_dim
        q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        self.wq = _param((d, q), cfg, device, ("embed", "qkv_flat"))
        self.wk = _param((d, kv), cfg, device, ("embed", "qkv_flat"))
        self.wv = _param((d, kv), cfg, device, ("embed", "qkv_flat"))
        self.wo = _param((q, d), cfg, device, ("qkv_flat", "embed"))

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
        yg, new_cache = _attend(cfg, qg, k, v, pos, window=window,
                                mode=mode, cache=cache)
        y = yg.reshape(bsz, s, h * hd)
        return y @ self.wo.to(dt), new_cache


def _flash_kernel(qg, k, v, *, window, cfg: ModelConfig) -> torch.Tensor:
    """``ops.flash_mha`` (the flash kernel; its plain version on the CPU).
    On ``meta`` tensors, which hold no values, the launch is planned
    (``flash_attention.plan``: what the kernel takes) and an output of its
    shape is returned: the dry run's stand-in, never a computation."""
    if qg.device.type == "meta":
        from ..kernels import flash_attention as fa
        fa.plan(qg, k, v, window)
        return torch.empty_like(qg)
    return ops.flash_mha(qg, k, v, window=window,
                         soft_cap=cfg.logits_soft_cap, bk=cfg.flash_chunk)


def _attend(cfg: ModelConfig, qg: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, pos: torch.Tensor, *, window: Optional[int],
            mode: str, cache: Optional[Cache] = None, kv_sel=None
            ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Attention of roped ``qg`` (B, S, KV, G, hd) on roped ``k``, ``v``
    (B, S, KVc, hd), filling or reading ``cache`` (the KVc heads);
    ``kv_sel`` (a slice or index tensor over KVc, default all) picks
    the heads ``qg``'s KV groups attend to. Returns yg (B, S, KV, G,
    hd) and the cache."""
    s, hd, dt = qg.shape[1], qg.shape[-1], qg.dtype
    sel = slice(None) if kv_sel is None else kv_sel
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
        slot = torch.arange(s_alloc, device=qg.device)
        abs_pos = torch.where(slot <= wpos, slot + (end - wpos),
                              slot + (end - wpos) - s_alloc)
        valid = (abs_pos >= 0) & (abs_pos <= end)
        if window is not None:
            valid &= abs_pos > end - window
        logits = torch.einsum("bqkgd,bskd->bkgqs", qg,
                              ck[:, :, sel].to(dt)) / math.sqrt(hd)
        logits = _soft_cap(logits, cfg.logits_soft_cap)
        logits = torch.where(valid, logits, NEG_INF)
        att = torch.softmax(logits.to(torch.float32), dim=-1).to(dt)
        return torch.einsum("bkgqs,bskd->bqkgd", att,
                            cv[:, :, sel].to(dt)), new_cache
    if mode == "prefill":
        if cache is not None:
            # the last min(S, alloc) keys go into the ring buffer
            alloc = cache["k"].shape[1]
            ln = min(s, alloc)
            slots = torch.arange(s - ln, s, device=qg.device) % alloc
            cache["k"][:, slots] = k[:, -ln:].to(cache["k"].dtype)
            cache["v"][:, slots] = v[:, -ln:].to(cache["v"].dtype)
            cache["end"] = s
            new_cache = cache
        else:
            new_cache = {"k": k, "v": v, "end": s}
    k, v = k[:, :, sel], v[:, :, sel]
    if s >= FLASH_THRESHOLD and mode == "train":
        # differentiable chunked attention: the kernel has no backward
        yg = _flash_attention(qg, k, v, pos, pos, window=window,
                              soft_cap=cfg.logits_soft_cap,
                              chunk=cfg.flash_chunk)
    elif s >= FLASH_THRESHOLD:
        # the flash kernel: no (S x S) scores in memory
        yg = _flash_kernel(qg, k, v, window=window, cfg=cfg)
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
    return yg, new_cache


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
        axes = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
                "w_down": ("mlp", "embed")}
        for name, shape in shapes.items():
            setattr(self, name, _param(shape, cfg, device, axes[name]))
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
# The sharded dense block. Each function takes one tensor a mesh
# coordinate (``models.spmd``) and the ``model.ShardedModel`` whose weights
# it reads; ``act`` is the axes the activations' batch splits over. A
# weight comes from ``ShardedModel.weight``: every mesh axis of it
# all-gathered (FSDP's "embed" -> "data" included) but the tensor-parallel
# axes of its parallel dim, with the span of that dim the coordinate holds.
def _row_reduce(outs, sm, axes, what: str):
    """The all-reduce after a row-parallel product (``what``: "wo" or
    "w_down"); none where the contraction dim is not sharded."""
    return spmd.all_reduce(outs, sm.mesh, axes) if axes else outs


def _whole_heads(sm, xs, spans, axes, hd: int, width: int):
    """Per-coordinate column slices of a flat (..., heads * hd) projection,
    all-gathered over ``axes`` where a slice is not whole heads (as GSPMD
    reshards)."""
    if all(a % hd == 0 and b % hd == 0 for a, b in spans):
        return xs, spans
    return (spmd.all_gather(xs, sm.mesh, axes, -1),
            [(0, width)] * len(xs))


def _head_groups(q: torch.Tensor, h0: int, h1: int, g: int, kv0: int):
    """Query heads [h0, h1) (q: (B, S, n, hd)) arranged for ``_attend``:
    (B, S, KV', G', hd) and the selection of KV' heads among the kv heads
    held from ``kv0``. Whole groups keep JAX's layout; the heads of one kv
    head share it; heads that cut groups unevenly attend one head a
    group."""
    bsz, s, n, hd = q.shape
    if h0 % g == 0 and n % g == 0:
        a = h0 // g - kv0
        return q.view(bsz, s, n // g, g, hd), slice(a, a + n // g)
    if h0 // g == (h1 - 1) // g:
        a = h0 // g - kv0
        return q.view(bsz, s, 1, n, hd), slice(a, a + 1)
    idx = torch.arange(h0, h1, device=q.device) // g - kv0
    return q.view(bsz, s, n, 1, hd), idx


def attention_sharded(sm, li: int, xs, pos, *, window, mode: str,
                      caches, act) -> Tuple[list, Optional[Cache]]:
    """``Attention`` over the mesh: column-parallel ``wq``/``wk``/``wv``,
    whole heads a coordinate (a slice that is not whole heads, or kv heads
    another coordinate holds, all-gathered over the model axes first),
    ``_attend`` on the coordinate's heads (a long prefill launches the
    flash kernel once a coordinate), row-parallel ``wo`` and its
    all-reduce. ``caches``: the layer's sharded cache (``ShardedModel.
    init_cache``) or None."""
    cfg, n = sm.cfg, len(xs)
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g, dt = h // kvh, xs[0].dtype
    pre = f"blocks.{li}.mixer."
    wq, qspan, qax = sm.weight(pre + "wq", 1, act, dt)
    q, qspan = _whole_heads(sm, [x @ w for x, w in zip(xs, wq)], qspan,
                            qax, hd, h * hd)
    wk, kspan, kax = sm.weight(pre + "wk", 1, act, dt)
    wv = sm.weight(pre + "wv", 1, act, dt)[0]
    k = [x @ w for x, w in zip(xs, wk)]
    v = [x @ w for x, w in zip(xs, wv)]
    need = []                       # kv heads [lo, hi) each coordinate
    for i in range(n):
        h0, h1 = qspan[i][0] // hd, qspan[i][1] // hd
        lo, hi = h0 // g, (h1 - 1) // g + 1
        if caches is not None:
            c0, c1 = caches["k"].span(i, 2)
            if not (c0 <= lo and hi <= c1):
                raise ValueError(f"layer {li}: coordinate {i} attends kv "
                                 f"heads [{lo}, {hi}), its cache holds "
                                 f"[{c0}, {c1})")
            lo, hi = c0, c1
        need.append((lo, hi))
    if any(not (a <= lo * hd and hi * hd <= b)
           for (a, b), (lo, hi) in zip(kspan, need)):
        k = spmd.all_gather(k, sm.mesh, kax, -1)
        v = spmd.all_gather(v, sm.mesh, kax, -1)
        kspan = [(0, kvh * hd)] * n
    ys, new = [], None if caches is None else dict(caches)
    for i in range(n):
        bsz, s = xs[i].shape[:2]
        (a, _), (lo, hi) = kspan[i], need[i]
        cols = slice(lo * hd - a, hi * hd - a)
        ki = _rope(k[i][..., cols].reshape(bsz, s, hi - lo, hd), pos[i],
                   cfg.rope_theta)
        vi = v[i][..., cols].reshape(bsz, s, hi - lo, hd)
        h0, h1 = qspan[i][0] // hd, qspan[i][1] // hd
        qi = _rope(q[i].view(bsz, s, h1 - h0, hd), pos[i], cfg.rope_theta)
        qg, sel = _head_groups(qi, h0, h1, g, lo)
        cache = None
        if caches is not None:
            cache = {"k": caches["k"].shards[i], "v": caches["v"].shards[i],
                     "end": caches["end"]}
        yg, cache = _attend(cfg, qg, ki, vi, pos[i], window=window,
                            mode=mode, cache=cache, kv_sel=sel)
        if caches is not None:
            new["end"] = cache["end"]
        ys.append((yg.reshape(bsz, s, (h1 - h0) * hd), h0 * hd))
    wo, ospan, oax = sm.weight(pre + "wo", 0, act, dt)
    outs = []
    for (y, y0), (a, b), w in zip(ys, ospan, wo):
        if a < y0 or b > y0 + y.shape[-1]:
            raise ValueError(f"layer {li}: wo rows [{a}, {b}) are not "
                             f"among the coordinate's heads' columns")
        outs.append(y[..., a - y0:b - y0] @ w)
    return _row_reduce(outs, sm, oax, "wo"), new


def mlp_sharded(sm, li: int, xs, act) -> list:
    """``MLP`` over the mesh: column-parallel ``w_gate``/``w_up``,
    row-parallel ``w_down`` and its all-reduce."""
    cfg, dt = sm.cfg, xs[0].dtype
    pre = f"blocks.{li}.ffn."
    wu, uspan, _ = sm.weight(pre + "w_up", 1, act, dt)
    u = [x @ w for x, w in zip(xs, wu)]
    if cfg.mlp_type == "swiglu":
        wg = sm.weight(pre + "w_gate", 1, act, dt)[0]
        hdn = [F.silu(x @ w) * ui for x, w, ui in zip(xs, wg, u)]
    else:
        hdn = [F.gelu(ui, approximate="tanh") for ui in u]
    wd, dspan, dax = sm.weight(pre + "w_down", 0, act, dt)
    outs = []
    for hh, (u0, u1), (a, b), w in zip(hdn, uspan, dspan, wd):
        if a < u0 or b > u1:
            raise ValueError(f"layer {li}: w_down rows [{a}, {b}) are not "
                             f"among w_up's columns [{u0}, {u1})")
        outs.append(hh[..., a - u0:b - u0] @ w)
    return _row_reduce(outs, sm, dax, "w_down")


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


class _Embed(torch.autograd.Function):
    """table[tokens]. The backward adds each token's grads in the order
    the tokens come (flattened), one ``index_add_`` per occurrence rank
    (the k-th repeat of every token in one add, whose rows are distinct):
    the same bits on every run and device, where the indexing backward
    on the CPU adds a repeated token's rows in parallel."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.shape = table.shape
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        tokens, = ctx.saved_tensors
        flat = tokens.reshape(-1)
        dt = g.new_zeros(ctx.shape)
        if flat.numel() == 0 or g.device.type == "meta":
            return dt, None             # meta holds shapes, no values
        g = g.reshape(flat.shape[0], -1)
        order = torch.sort(flat, stable=True).indices
        tok = flat[order]
        pos = torch.arange(tok.shape[0], device=tok.device)
        first = torch.ones_like(tok, dtype=torch.bool)
        first[1:] = tok[1:] != tok[:-1]
        start = torch.cummax(torch.where(first, pos, 0), 0).values
        rank = torch.empty_like(flat)           # occurrence of its token
        rank[order] = pos - start
        # rank-major, each rank's positions in flat order: one slice a rank
        by_rank = torch.sort(rank, stable=True).indices
        a = 0
        for c in torch.bincount(rank).tolist():
            sel = by_rank[a:a + c]
            dt.index_add_(0, flat[sel], g[sel])
            a += c
        return dt, None


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` whose gradient sums a repeated token's rows in
    token order, bit for bit from run to run (``_Embed``)."""
    return _Embed.apply(table, tokens)


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
        self.router = _param((d, e), cfg, device, ("embed", "experts"))
        self.w_gate = _param((e, d, f), cfg, device,
                             ("experts", "embed", "expert_mlp"))
        self.w_up = _param((e, d, f), cfg, device,
                           ("experts", "embed", "expert_mlp"))
        self.w_down = _param((e, f, d), cfg, device,
                             ("experts", "expert_mlp", "embed"))
        if cfg.n_shared_experts:
            fs = cfg.n_shared_experts * f
            self.ws_gate = _param((d, fs), cfg, device, ("embed", "mlp"))
            self.ws_up = _param((d, fs), cfg, device, ("embed", "mlp"))
            self.ws_down = _param((fs, d), cfg, device, ("mlp", "embed"))
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


# ======================================================================
# Mamba2 SSD (chunked state-space duality) and the RG-LRU.
def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 cache: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B, S, C), w: (W, C); ``cache`` (B, W-1,
    C) is the left context (zeros when None). Returns (y, new_cache), the
    new cache the last W-1 inputs in ``x.dtype`` (a copy: it does not keep
    the padded input alive)."""
    wlen, s = w.shape[0], x.shape[1]
    if cache is None:
        pad = x.new_zeros((x.shape[0], wlen - 1, x.shape[2]))
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    new_cache = (xp[:, -(wlen - 1):] if wlen > 1 else pad[:, :0]).clone()
    y = sum(xp[:, i:i + s] * w[i] for i in range(wlen))
    return y, new_cache


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along dim 1 from h_{-1} = 0, for every t:
    a doubling (Hillis-Steele) scan, ceil(log2 S) steps of elementwise
    torch ops, each combining step t with step t - d."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < s:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    """The recurrences' dtype: f32, or f64 in an f64 model."""
    return torch.promote_types(dt, torch.float32)


class SSD(nn.Module):
    """Mamba2's SSD mixer (JAX ``layers.ssd``): ``w_x``/``w_z`` (d, inner),
    ``w_bc`` (d, 2N), ``w_dt`` (d, H), ``dt_bias``/``a_log``/``d_skip``
    (H,), ``conv_w`` (W, inner + 2N), ``w_out`` (inner, d)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        d, inner, n, nh = (cfg.d_model, cfg.ssm_inner, cfg.ssm_state,
                           cfg.ssm_heads)
        self.w_x = _param((d, inner), cfg, device, ("embed", "ssm_inner"))
        self.w_z = _param((d, inner), cfg, device, ("embed", "ssm_inner"))
        self.w_bc = _param((d, 2 * n), cfg, device, ("embed", None))
        self.w_dt = _param((d, nh), cfg, device, ("embed", None))
        self.dt_bias = _param((nh,), cfg, device, (None,))
        self.a_log = _param((nh,), cfg, device, (None,))
        self.d_skip = _param((nh,), cfg, device, (None,))
        self.conv_w = _param((cfg.conv_width, inner + 2 * n), cfg, device,
                             ("conv_width", None))
        self.w_out = _param((inner, d), cfg, device, ("ssm_inner", "embed"))

    def forward(self, x: torch.Tensor, *, mode: str,
                cache: Optional[Cache] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """x: (B, S, d). ``train`` and ``prefill`` run the chunked form
        (``prefill`` starting from ``cache``'s state and conv tail when
        given, and filling it); ``decode`` one step of the recurrence.
        Returns the output and the cache (None in ``train`` mode)."""
        cfg = self.cfg
        bsz, s, _ = x.shape
        inner, n, nh, hp = (cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads,
                            cfg.ssm_head_dim)
        dt_ = x.dtype
        acc = _acc_dtype(dt_)
        z = x @ self.w_z.to(dt_)
        xin = x @ self.w_x.to(dt_)
        bc = x @ self.w_bc.to(dt_)
        conv_out, new_conv = _causal_conv(
            torch.cat([xin, bc], dim=-1), self.conv_w.to(dt_),
            None if cache is None else cache["conv"])
        conv_out = F.silu(conv_out)
        xs = conv_out[..., :inner].reshape(bsz, s, nh, hp)
        bmat = conv_out[..., inner:inner + n]                    # (B, S, N)
        cmat = conv_out[..., inner + n:]                         # (B, S, N)
        dt = F.softplus((x @ self.w_dt.to(dt_)).to(acc)
                        + self.dt_bias.to(acc))                  # (B, S, H)
        adt = dt * -torch.exp(self.a_log.to(acc))                # <= 0

        if mode == "decode":
            if cache is None or s != 1:
                raise ValueError("decode mode needs a cache and a "
                                 "single-token step")
            st = cache["state"].to(acc)                          # (B,H,P,N)
            x1 = xs[:, 0].to(acc)                                # (B, H, P)
            xb = x1[..., None] * bmat[:, 0].to(acc)[:, None, None, :]
            st = (torch.exp(adt[:, 0])[..., None, None] * st
                  + dt[:, 0][..., None, None] * xb)
            y = (st @ cmat[:, 0].to(acc)[:, None, :, None])[..., 0]
            y = y + self.d_skip.to(acc)[None, :, None] * x1
            y = y.reshape(bsz, 1, inner).to(dt_)
            cache["conv"] = new_conv
            cache["state"] = st.to(cache["state"].dtype)
            cache["end"] = int(cache["end"]) + 1
            new_cache = cache
        else:
            init = (cache["state"].to(acc) if cache is not None else
                    x.new_zeros((bsz, nh, hp, n), dtype=acc))
            y, final = self._chunked(xs, bmat, cmat, dt, adt, init)
            y = y.reshape(bsz, -1, inner)[:, :s].to(dt_)
            new_cache = None
            if mode == "prefill":
                new_cache = {} if cache is None else cache
                new_cache.update(conv=new_conv, state=final.to(dt_), end=s)
        y = y * F.silu(z)
        return y @ self.w_out.to(dt_), new_cache

    def _chunked(self, xs, bmat, cmat, dt, adt, init):
        """The chunked SSD over S padded to a multiple of the chunk with
        identity steps (decay 1, zero input), so the final state is exact.
        Returns y (B, Sp, H, P) in the recurrences' dtype and the final
        state (B, H, P, N)."""
        bsz, s, nh, hp = xs.shape
        n = bmat.shape[-1]
        acc = init.dtype
        q = min(self.cfg.ssm_chunk, s)
        sp = -(-s // q) * q
        if sp != s:
            xs = F.pad(xs, (0, 0, 0, 0, 0, sp - s))
            bmat, cmat = (F.pad(t, (0, 0, 0, sp - s)) for t in (bmat, cmat))
            dt, adt = (F.pad(t, (0, 0, 0, sp - s)) for t in (dt, adt))
        nc = sp // q
        xs = xs.to(acc)
        xs_h = xs.reshape(bsz, nc, q, nh, hp).transpose(2, 3)   # (B,C,H,Q,P)
        b_c = bmat.reshape(bsz, nc, q, n).to(acc)
        c_c = cmat.reshape(bsz, nc, q, n).to(acc)
        dt_h = dt.reshape(bsz, nc, q, nh).transpose(2, 3)       # (B,C,H,Q)
        cum = torch.cumsum(adt.reshape(bsz, nc, q, nh), dim=2).transpose(
            2, 3)                                               # (B,C,H,Q)
        # intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j, else 0, the
        # mask inside the exponent (the upper triangle's exp overflows)
        tri = torch.ones((q, q), dtype=torch.bool, device=xs.device).tril()
        lmat = torch.exp(torch.where(
            tri, cum[..., :, None] - cum[..., None, :], float("-inf")))
        cb = c_c @ b_c.transpose(-1, -2)                        # (B,C,Q,K)
        y = (cb[:, :, None] * lmat * dt_h[..., None, :]) @ xs_h  # (B,C,H,Q,P)
        # chunk-final states: sum_k exp(cum_end - cum_k) dt_k x_k b_k^T
        w_end = torch.exp(cum[..., -1:] - cum) * dt_h           # (B,C,H,Q)
        s_local = (xs_h * w_end[..., None]).transpose(-1, -2) @ \
            b_c[:, :, None]                                     # (B,C,H,P,N)
        chunk_decay = torch.exp(cum[..., -1])                   # (B,C,H)
        prev, st = [], init
        for c in range(nc):                 # the state before each chunk
            prev.append(st)
            st = chunk_decay[:, c, :, None, None] * st + s_local[:, c]
        prev = torch.stack(prev, dim=1)                         # (B,C,H,P,N)
        y_inter = (c_c[:, :, None] @ prev.transpose(-1, -2)) * \
            torch.exp(cum)[..., None]                           # (B,C,H,Q,P)
        y = (y + y_inter).transpose(2, 3).reshape(bsz, sp, nh, hp)
        y = y + self.d_skip.to(acc)[None, None, :, None] * xs
        return y, st


def init_ssd_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                   device=None) -> Cache:
    return {"conv": torch.zeros((batch, cfg.conv_width - 1,
                                 cfg.ssm_inner + 2 * cfg.ssm_state),
                                dtype=dtype, device=device),
            "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                  cfg.ssm_state), dtype=dtype, device=device),
            "end": 0}


_LRU_C = 8.0


class RGLRU(nn.Module):
    """Griffin's recurrent block (JAX ``layers.rglru``): a GELU gate branch
    times the RG-LRU branch. ``w_in``/``w_gate_branch`` (d, w), ``conv_w``
    (W, w), ``w_rg``/``w_ig`` (w, w) (recurrence and input gates),
    ``a_param`` (w,), ``w_out`` (w, d)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        d, w = cfg.d_model, cfg.lru_dim
        self.w_in = _param((d, w), cfg, device, ("embed", "lru_width"))
        self.w_gate_branch = _param((d, w), cfg, device,
                                    ("embed", "lru_width"))
        self.conv_w = _param((cfg.conv_width, w), cfg, device,
                             ("conv_width", None))
        self.w_rg = _param((w, w), cfg, device, ("lru_width", None))
        self.w_ig = _param((w, w), cfg, device, ("lru_width", None))
        self.a_param = _param((w,), cfg, device, (None,))
        self.w_out = _param((w, d), cfg, device, ("lru_width", "embed"))

    def forward(self, x: torch.Tensor, *, mode: str,
                cache: Optional[Cache] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """x: (B, S, d); the modes and the cache as ``SSD.forward``'s."""
        bsz, s, _ = x.shape
        dt = x.dtype
        acc = _acc_dtype(dt)
        gate = F.gelu(x @ self.w_gate_branch.to(dt), approximate="tanh")
        u, new_conv = _causal_conv(x @ self.w_in.to(dt), self.conv_w.to(dt),
                                   None if cache is None else cache["conv"])
        r = torch.sigmoid((u @ self.w_rg.to(dt)).to(acc))
        i = torch.sigmoid((u @ self.w_ig.to(dt)).to(acc))
        log_a = _LRU_C * r * (-torch.exp(self.a_param.to(acc)) - 1e-3)
        a = torch.exp(log_a)                                     # (B, S, w)
        beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                      min=1e-9)) * (i * u.to(acc))
        if mode == "decode":
            if cache is None or s != 1:
                raise ValueError("decode mode needs a cache and a "
                                 "single-token step")
            h = a[:, 0] * cache["state"].to(acc) + beta[:, 0]
            y = h[:, None, :]
            cache["conv"] = new_conv
            cache["state"] = h.to(cache["state"].dtype)
            cache["end"] = int(cache["end"]) + 1
            new_cache = cache
        else:
            if cache is not None:           # the initial state enters b_0
                b0 = beta[:, :1] + a[:, :1] * cache["state"].to(acc)[:, None]
                beta = torch.cat([b0, beta[:, 1:]], dim=1)
            y = linear_scan(a, beta)
            new_cache = None
            if mode == "prefill":
                new_cache = {} if cache is None else cache
                new_cache.update(conv=new_conv, state=y[:, -1].to(dt), end=s)
        y = y.to(dt) * gate
        return y @ self.w_out.to(dt), new_cache


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device=None) -> Cache:
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, cfg.lru_dim),
                                dtype=dtype, device=device),
            "state": torch.zeros((batch, cfg.lru_dim), dtype=dtype,
                                 device=device),
            "end": 0}
