"""Weight pruning to BSR, and the functional density schedule.

The port of ``repro.sparse.prune`` (numpy only)."""
from __future__ import annotations

import numpy as np

from ..core.bsr import BSR, magnitude_block_mask
from .pattern import PruneSchedule


def prune_to_bsr(w: np.ndarray, block: int, density: float) -> BSR:
    """Magnitude-prune a dense weight to block density and pack as BSR.

    Every block-row keeps at least one block so no output feature goes dead
    (see ``magnitude_block_mask``)."""
    mask = magnitude_block_mask(np.asarray(w), (block, block), density)
    return BSR.from_mask(np.asarray(w), mask, (block, block))


def sparsity_schedule(step: int, total_steps: int, final_density: float,
                      warmup_frac: float = 0.1) -> float:
    """Cubic density schedule (dense -> final_density), Zhu & Gupta style:
    the functional view of ``PruneSchedule.density_at``. Invalid inputs
    raise ``ValueError``."""
    return PruneSchedule(final_density, total_steps,
                         warmup_frac).density_at(step)
