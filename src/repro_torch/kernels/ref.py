"""Plain torch oracles (the port of ``repro.kernels.ref``: InCRS, the
per-round CRS form of index matching, BSR, the dense matmul, and causal
grouped-query flash attention).

They run on any device and are what the tests and ``chip_smoke.py`` hold
the kernels against. The main path never calls them on a CUDA tensor.
"""
from __future__ import annotations

import numpy as np
import torch


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense C = A @ B in f32."""
    return a.to(torch.float32) @ b.to(torch.float32)


def round_densify(idx: torch.Tensor, val: torch.Tensor, n_cols: int,
                  rounds: int) -> torch.Tensor:
    """Densify padded per-round sparse rows (LOCAL index in ``[0, rounds)``,
    -1 = pad) to f32 (M, n_rounds * rounds)[:, :n_cols]."""
    m, n_rounds, _ = idx.shape
    live = (idx >= 0) & (idx < rounds)
    base = torch.arange(n_rounds, device=idx.device).view(1, -1, 1) * rounds
    cols = torch.where(live, idx.long() + base, 0).reshape(m, -1)
    vals = torch.where(live, val.to(torch.float32), 0.0).reshape(m, -1)
    dense = torch.zeros(m, n_rounds * rounds, dtype=torch.float32,
                        device=idx.device)
    dense.scatter_add_(1, cols, vals)
    return dense[:, :n_cols]


def index_match_spmm(a_idx: torch.Tensor, a_val: torch.Tensor,
                     b_idx: torch.Tensor, b_val: torch.Tensor, n_cols: int,
                     rounds: int) -> torch.Tensor:
    """C = A @ B.T in f32 from the padded per-round sparse-row form: the
    oracle of the round-synchronized index-matching kernel."""
    da = round_densify(a_idx, a_val, n_cols, rounds)
    db = round_densify(b_idx, b_val, n_cols, rounds)
    return matmul(da, db.T)


def incrs_decompress(idx: torch.Tensor, val: torch.Tensor, n_cols: int,
                     section: int) -> torch.Tensor:
    """Densify padded per-(row, section) stripes (local column inside the
    section, -1 = pad) to f32 (M, n_sections * section)[:, :n_cols]."""
    return round_densify(idx, val, n_cols, section)


def bsr_spmm(row_of: torch.Tensor, col_of: torch.Tensor,
             values: torch.Tensor, b: torch.Tensor,
             n_block_rows: int) -> torch.Tensor:
    """C = BSR(A) @ B from the kernel's block lists: gather the B
    block-row of every stored block, one batched product, then add each
    block's (bm, N) product into its block-row of C. f32 sums, C in
    ``b.dtype``. ``row_of`` may carry the trailing sentinel."""
    nnz, bm, bk = values.shape
    k, n = b.shape
    out = torch.zeros(n_block_rows, bm, n, dtype=torch.float32,
                      device=b.device)
    if nnz:
        slabs = b.to(torch.float32).reshape(k // bk, bk, n)[col_of.long()]
        prod = torch.bmm(values.to(torch.float32), slabs)
        out.index_add_(0, row_of[:nnz].long(), prod)
    return out.reshape(n_block_rows * bm, n).to(b.dtype)


def dense_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with f32 sums, in ``a.dtype``."""
    return matmul(a, b).to(a.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window=None, soft_cap=None, chunk: int = 1024,
                    q_offset: int = 0) -> torch.Tensor:
    """Causal grouped-query attention over positions 0..S-1, as the
    Pallas ``flash_attention`` and ``layers._flash_attention`` compute it.

    q (B, Sq, KV, G, hd), k/v (B, Sk, KV, hd) -> (B, Sq, KV, G, hd) in
    ``q.dtype``; query row r sits at position r + ``q_offset`` (a span of
    a longer sequence whose keys start at 0). Keys of ``chunk`` at a time
    with an online softmax in f32 (m, l, acc), so the (Sq, Sk) scores
    never exist whole: at granite-34b's
    wave (B = 2, S = 8192, 48 heads) one chunk of 1024 keys takes 3.2 GB
    where the whole score matrix would take 25.8 GB. Key j counts for query
    i iff j <= i and, with a window, j > i - window; the soft cap is
    ``soft_cap * tanh(logit / soft_cap)`` when truthy; a row with no valid
    key gives 0."""
    bsz, sq, kvh, g, hd = q.shape
    sk = k.shape[1]
    dev = q.device
    scale = 1.0 / float(np.sqrt(hd))
    qf = q.to(torch.float32).permute(0, 2, 3, 1, 4)       # (B, KV, G, Sq, hd)
    qpos = q_offset + torch.arange(sq, device=dev)[:, None]
    m = torch.full((bsz, kvh, g, sq), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((bsz, kvh, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((bsz, kvh, g, sq, hd), dtype=torch.float32,
                      device=dev)
    for s0 in range(0, sk, chunk):
        kb = k[:, s0:s0 + chunk].to(torch.float32)
        vb = v[:, s0:s0 + chunk].to(torch.float32)
        logits = torch.einsum("bkgqd,bskd->bkgqs", qf, kb) * scale
        if soft_cap:
            logits = soft_cap * torch.tanh(logits / soft_cap)
        kpos = torch.arange(s0, s0 + kb.shape[1], device=dev)[None, :]
        valid = kpos <= qpos                                # (Sq, chunk)
        if window is not None:
            valid &= kpos > qpos - window
        logits = torch.where(valid, logits, -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(logits - m_new[..., None]), 0.0)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p,
                                                   vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)
