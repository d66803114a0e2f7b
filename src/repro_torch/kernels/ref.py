"""Plain torch oracles (the port of ``repro.kernels.ref``, InCRS part).

They run on any device and are what the tests and ``chip_smoke.py`` hold
the kernels against. The main path never calls them on a CUDA tensor.
"""
from __future__ import annotations

import torch


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense C = A @ B in f32."""
    return a.to(torch.float32) @ b.to(torch.float32)


def incrs_decompress(idx: torch.Tensor, val: torch.Tensor, n_cols: int,
                     section: int) -> torch.Tensor:
    """Densify padded per-(row, section) stripes (local column inside the
    section, -1 = pad) to f32 (M, n_sections * section)[:, :n_cols]."""
    m, n_sections, _ = idx.shape
    live = (idx >= 0) & (idx < section)
    base = torch.arange(n_sections, device=idx.device).view(1, -1, 1) \
        * section
    cols = torch.where(live, idx.long() + base, 0).reshape(m, -1)
    vals = torch.where(live, val.to(torch.float32), 0.0).reshape(m, -1)
    dense = torch.zeros(m, n_sections * section, dtype=torch.float32,
                        device=idx.device)
    dense.scatter_add_(1, cols, vals)
    return dense[:, :n_cols]
