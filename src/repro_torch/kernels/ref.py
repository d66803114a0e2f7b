"""Plain torch oracles (the port of ``repro.kernels.ref``: InCRS and the
per-round CRS form of index matching).

They run on any device and are what the tests and ``chip_smoke.py`` hold
the kernels against. The main path never calls them on a CUDA tensor.
"""
from __future__ import annotations

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
