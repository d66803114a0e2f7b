"""Synthetic sparse datasets with the paper's published statistics.

The port's own copy of ``repro.data.datasets``: the same seed gives the
same CRS arrays, bit for bit. Row degrees follow a clipped lognormal fitted
to the published (min, avg, max) non-zeros per row; column placement mixes
a uniform background with a Zipf-like popularity skew.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.crs import CRS


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    m: int
    n: int
    density: float
    row_nnz: Optional[Tuple[int, int, int]] = None    # (min, avg, max)
    skew: float = 0.8            # 0 = uniform columns, 1 = strongly skewed


# Table II (the resized second operands of the InCRS experiments).
TABLE2_DATASETS: Dict[str, DatasetSpec] = {
    "amazon":    DatasetSpec("amazon",    300, 10_000, 0.14,  (501, 1400, 2011)),
    "belcastro": DatasetSpec("belcastro", 370, 22_000, 0.06,  (1, 1300, 6787)),
    "docword":   DatasetSpec("docword",   700, 12_000, 0.04,  (2, 480, 906)),
    # Table II prints D=1% for Norris, but its own NZ/row stats (avg 360 of
    # 3600 cols) and its storage ratio 0.98 both imply D=10%.
    "norris":    DatasetSpec("norris",   1200,  3_600, 0.10,  (3, 360, 795)),
    "mks":       DatasetSpec("mks",      3500,  7_500, 0.015, (18, 112, 957)),
}

# Table IV (the A x A^T architecture experiments), in density order.
TABLE4_DATASETS: Dict[str, DatasetSpec] = {
    "amazon4":  DatasetSpec("amazon4", 1500, 10_000, 0.14),
    "docword4": DatasetSpec("docword4", 1500, 12_000, 0.04),
    "mks4":     DatasetSpec("mks4",    7500,  7_500, 0.015),
    "norris4":  DatasetSpec("norris4", 3600,  3_600, 0.01),
    "arenas":   DatasetSpec("arenas",  1100,  1_100, 0.0085),
    "bates":    DatasetSpec("bates",   3000,  3_000, 0.0011),
    "gleich":   DatasetSpec("gleich",  2400,  2_400, 0.00095),
    "sch":      DatasetSpec("sch",     3600,  3_600, 0.00057),
}


def _row_degrees(spec: DatasetSpec, rng: np.random.Generator) -> np.ndarray:
    """Per-row NZ counts matching (min, avg, max) if given, else a
    lognormal around N*D clipped to [1, N]."""
    target_total = int(round(spec.m * spec.n * spec.density))
    if spec.row_nnz is not None:
        lo, avg, hi = spec.row_nnz
        sigma = 0.6 if hi > 3 * max(avg, 1) else 0.3
        mu = np.log(max(avg, 1.0)) - sigma * sigma / 2.0
        deg = np.exp(rng.normal(mu, sigma, spec.m))
        deg = np.clip(deg, lo, hi)
    else:
        avg = spec.n * spec.density
        sigma = 0.5
        mu = np.log(max(avg, 1.0)) - sigma * sigma / 2.0
        deg = np.clip(np.exp(rng.normal(mu, sigma, spec.m)), 1, spec.n)
    # rescale (without violating min/max clips) so the total matches density
    deg = deg * (target_total / max(deg.sum(), 1.0))
    if spec.row_nnz is not None:
        deg = np.clip(deg, spec.row_nnz[0], spec.row_nnz[2])
    return np.maximum(1, np.round(deg)).astype(np.int64)


def synthesize(spec: DatasetSpec, seed: int = 0) -> CRS:
    """Generate a CRS matrix with the spec's statistics (deterministic: the
    name is folded into the seed with crc32, never with ``hash()``)."""
    rng = np.random.default_rng(seed ^ zlib.crc32(spec.name.encode())
                                & 0xFFFF)
    deg = _row_degrees(spec, rng)
    pop = 1.0 / np.arange(1, spec.n + 1) ** spec.skew
    pop = pop / pop.sum()
    pop = 0.5 * pop + 0.5 / spec.n
    perm = rng.permutation(spec.n)         # popular columns scattered
    pop = pop[perm]

    cols_list = []
    ptr = np.zeros(spec.m + 1, dtype=np.int64)
    for i in range(spec.m):
        k = min(int(deg[i]), spec.n)
        # Gumbel-top-k: weighted sampling without replacement
        g = np.log(pop) + rng.gumbel(size=spec.n)
        cols = np.argpartition(g, -k)[-k:]
        cols.sort()
        cols_list.append(cols.astype(np.int32))
        ptr[i + 1] = ptr[i] + k
    col_idx = np.concatenate(cols_list) if cols_list else \
        np.zeros(0, dtype=np.int32)
    values = rng.uniform(0.5, 1.5, col_idx.shape[0]).astype(np.float32)
    return CRS(values, col_idx, ptr, (spec.m, spec.n))


def scaled(spec: DatasetSpec, factor: float) -> DatasetSpec:
    """Shrink a spec (rows/cols) for fast tests; density preserved."""
    row_nnz = None
    if spec.row_nnz is not None:
        lo, avg, hi = spec.row_nnz
        row_nnz = (max(1, int(lo * factor)), max(1, int(avg * factor)),
                   max(1, int(hi * factor)))
    return DatasetSpec(spec.name + f"@{factor}", max(8, int(spec.m * factor)),
                       max(8, int(spec.n * factor)), spec.density, row_nnz,
                       spec.skew)
