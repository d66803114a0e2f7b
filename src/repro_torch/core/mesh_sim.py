"""Cost models of the port's kernels on the H100: the cost half of
``repro.core.mesh_sim``.

The JAX module prices a Pallas grid in TPU cycles; here each launch is
reckoned from the port's own launch geometry (the wrappers' geometry
functions, the one source of each launch): CTAs and waves on the card's
132 SMs, the bytes it stages and reads (stripes or round windows, B) and
writes (C), and its multiply-adds. A launch's time is

    waves * wave_us + max(bytes / bytes_per_us, fmas / fma_per_us)

with the three constants of each kernel in ``RATES``, fitted from the
card's own times (``scripts/fit_cost_model.py`` over a run of
``chip_smoke.py``; ``PERF.md`` §6 names the run, the card and its power
limit). The byte and multiply-add rates are effective ones: B is read
through L2 more often than once, and the kernels do not reach the f32
peak, so a rate may sit above HBM's 3.35 TB/s or far below 33.5 TFMA/s.

``flops`` of an InCRS launch is the JAX model's (2 * slots * N), so the
two packages count the same work. The paper's latency models of the mesh
are not here (ROADMAP queue 1 item 13).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from .crs import CRS

SMS = 132                              # an H100 SXM


@dataclasses.dataclass(frozen=True)
class HopperRates:
    """One kernel's fitted constants: the fixed cost of a wave of CTAs,
    and the effective rates of its counted bytes and multiply-adds."""
    wave_us: float
    bytes_per_us: float
    fma_per_us: float

    def time_us(self, waves: int, nbytes: float, fmas: float) -> float:
        return waves * self.wave_us + max(nbytes / self.bytes_per_us,
                                          fmas / self.fma_per_us)


# Fitted by scripts/fit_cost_model.py to one run of chip_smoke.py on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6 names the run): the InCRS
# orders on 246 measured sweep candidates, index matching on 27 points,
# condense, merge and the gather on phase spgemm_operands' times.
RATES: Dict[str, HopperRates] = {
    "expand": HopperRates(57.66, 2.15e7, 7.892e6),
    "reuse": HopperRates(85.01, 2.517e7, 6.574e6),
    "pipelined": HopperRates(32.17, 1.417e7, 4.603e6),
    "index_match": HopperRates(55.1, 1.301e6, 4.646e10),
    "condense": HopperRates(29.9, 3.393e6, 1.258e7),
    "merge": HopperRates(11.01, 3.104e6, 2.922e6),
    "gather": HopperRates(6.533, 2.762e6, 1.144e7),
}


def _waves(ctas: int, per_sm: int) -> int:
    return max(1, -(-ctas // (max(1, per_sm) * SMS)))


# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FusedKernelCost:
    """One launch of an InCRS order at its launch geometry."""
    variant: str
    geometry: tuple           # what the launcher takes (launch_geometry)
    ctas: int
    ctas_per_sm: int          # as the wrapper counts them
    waves: int
    stripe_bytes: int         # stripes staged, once per column tile
    b_bytes: int              # B read
    c_bytes: int              # C written
    fmas: int                 # slot multiply-adds
    flops: int                # 2 * slots * N, as the JAX model counts
    predicted_us: float

    @property
    def hbm_bytes(self) -> int:
        return self.stripe_bytes + self.b_bytes + self.c_bytes


def fused_spmm_cost(variant: str, m: int, n: int, *, n_sections: int,
                    smax: int, section: int, bm: int = 128, bn: int = 128,
                    nnz: Optional[int] = None, geometry=None
                    ) -> FusedKernelCost:
    """The cost of one launch of the InCRS order ``variant`` on
    (M, n_sections, smax) stripes times a (n_sections * section, N) B, at
    ``geometry`` (default: the wrapper's, ``incrs_spmm.launch_geometry``,
    at M padded to ``bm``). Slots are ``nnz`` where given, else every
    stripe slot (M * n_sections * smax), as in the JAX model. Expand and
    reuse read a row of B per slot and column (through L2); pipelined
    streams B's (section, 32 * cols_per_lane * 2) blocks once per cluster
    of row tiles."""
    from ..kernels import incrs_spmm as _k     # torch only where priced
    if variant not in _k.ORDERS:
        raise ValueError(f"unknown variant {variant!r}")
    name = _k.ORDERS[variant]
    mp = -(-m // bm) * bm
    geo = geometry or _k.launch_geometry(name, n, smax, section, m=mp)
    x, y, _ = _k.launch_grid(name, geo, mp, n)
    per_sm = _k.assumed_ctas_per_sm(name, geo)
    slots = nnz if nnz is not None else m * n_sections * smax
    stripes = mp * n_sections * smax * 8            # idx i32 + val f32
    if variant == "pipelined":
        kp = n_sections * section
        cols = _k.PIPE_COLS * geo.cols_per_lane * _k.PIPE_BLOCKS
        b_bytes = (x // geo.cluster) * y * kp * cols * 4
    else:
        b_bytes = slots * n * 4
    fmas = slots * n
    c_bytes = mp * n * 4
    waves = _waves(x * y, per_sm)
    total = stripes * y + b_bytes + c_bytes
    return FusedKernelCost(variant, tuple(geo), x * y, per_sm, waves,
                           stripes * y, b_bytes, c_bytes, fmas,
                           2 * slots * n,
                           RATES[variant].time_us(waves, total, fmas))


# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MatchedKernelCost:
    """One sparse x sparse engine: its launches summed."""
    engine: str               # "index_match" | "condense_merge" | "densify"
    launches: int
    ctas: int
    waves: int
    hbm_bytes: int            # entries, windows and intermediates read and
                              # written, C written
    fmas: int
    flops: int
    predicted_us: float


def _match_terms(m: int, n: int, *, rounds: int, n_rounds: int,
                 rmax_a: int, rmax_b: int, stripes: bool, geometry=None
                 ) -> Tuple[int, int, int, int]:
    """(ctas, waves, bytes, fmas) of one index-matching (``stripes``
    False) or condense launch at ``geometry`` (default: the wrapper's):
    A's entries read once per column tile, B's once per row tile, one
    multiply-add per A slot and column of its tile; C (m x n) or the
    stripes (n_rounds x m x n) written."""
    from ..kernels import index_match_spmm as _im
    kernel = "spgemm_condense" if stripes else "index_match_spmm"
    geo = geometry or _im.match_geometry(m, n, n_rounds, rmax_a, rmax_b,
                                         rounds, kernel)
    ctas = geo.grid if geo.instance == "ring" else geo.tiles
    waves = _waves(ctas, _im.CTAS_PER_SM[geo.instance])
    entries = (geo.col_tiles * m * n_rounds * rmax_a * 8 +
               geo.row_tiles * n * n_rounds * rmax_b * 8)
    out = (n_rounds if stripes else 1) * m * n * 4
    fmas = m * n_rounds * rmax_a * geo.col_tiles * geo.tile_n
    return ctas, waves, entries + out, fmas


def index_match_cost(m: int, n: int, *, rounds: int, n_rounds: int,
                     rmax_a: int, rmax_b: int, geometry=None
                     ) -> MatchedKernelCost:
    """The fused index-matching launch (paper Alg. 2) on A (m, n_rounds,
    rmax_a) and B (n, n_rounds, rmax_b) round windows of ``rounds``."""
    ctas, waves, nbytes, fmas = _match_terms(
        m, n, rounds=rounds, n_rounds=n_rounds, rmax_a=rmax_a,
        rmax_b=rmax_b, stripes=False, geometry=geometry)
    return MatchedKernelCost(
        "index_match", 1, ctas, waves, nbytes, fmas,
        2 * m * n_rounds * rmax_a * n,
        RATES["index_match"].time_us(waves, nbytes, fmas))


@dataclasses.dataclass(frozen=True)
class SpGEMMCost:
    """The three sparse x sparse engines, ready to compare."""
    spgemm: MatchedKernelCost     # condense + merge
    fused: MatchedKernelCost      # index matching, one launch
    densify: MatchedKernelCost    # the gather, then the fused InCRS SpMM

    def predicted_us(self) -> Dict[str, float]:
        """Predicted µs by ``ops.spmm`` variant name."""
        return {"reference": self.fused.predicted_us,
                "condense_merge": self.spgemm.predicted_us,
                "densify": self.densify.predicted_us}

    @property
    def pick(self) -> str:
        """The cheapest engine as an ``ops.spmm`` variant name."""
        us = self.predicted_us()
        return min(us, key=us.get)


def spgemm_cost(m: int, n: int, k: int, *, rounds: int, n_rounds: int,
                rmax_a: int, rmax_b: int, section: int, n_sections: int,
                smax_a: int, smax_b: int) -> SpGEMMCost:
    """All three engines of C[M, N] = A[M, K] @ B[N, K].T at the wrappers'
    geometries: index matching (one launch); condense (its stripes
    written) then merge (the stripes read, C written); densify: the gather
    of B's section stripes into a dense (N, K) (rows padded to 8, as
    ``ops.incrs_to_dense`` preps them) then the fused InCRS SpMM on A's
    stripes (rows padded to 128) at N columns, the order
    ``autotune.model_pick_variant`` picks."""
    from ..kernels import autotune
    from ..kernels import incrs_gather as _g
    from ..spgemm import kernels as _sk        # circular at module scope
    fused = index_match_cost(m, n, rounds=rounds, n_rounds=n_rounds,
                             rmax_a=rmax_a, rmax_b=rmax_b)
    ctas, waves, nbytes, fmas = _match_terms(
        m, n, rounds=rounds, n_rounds=n_rounds, rmax_a=rmax_a,
        rmax_b=rmax_b, stripes=True)
    cond_us = RATES["condense"].time_us(waves, nbytes, fmas)
    mg = _sk.merge_geometry(m * n, n_rounds)
    m_waves = _waves(mg.grid, _sk.merge_ctas(mg.smem) if mg.smem else 1)
    m_bytes = (n_rounds + 1) * m * n * 4
    merge_us = RATES["merge"].time_us(m_waves, m_bytes, 0)
    sp = MatchedKernelCost(
        "condense_merge", 2, ctas + mg.grid, waves + m_waves,
        nbytes + m_bytes, fmas, fused.flops, cond_us + merge_us)

    nb = -(-n // 8) * 8
    gg = _g.gather_geometry(nb, n_sections, smax_b, section)
    g_waves = _waves(gg.grid, gg.ctas_per_sm or 1)
    g_bytes = nb * n_sections * smax_b * 8 + nb * n_sections * section * 4
    g_us = RATES["gather"].time_us(g_waves, g_bytes, 0)
    np_ = -(-n // 128) * 128
    mp = -(-m // 128) * 128
    variant = autotune.model_pick_variant(mp, np_, n_sections=n_sections,
                                          smax=smax_a, section=section)
    f = fused_spmm_cost(variant, mp, np_, n_sections=n_sections,
                        smax=smax_a, section=section)
    de = MatchedKernelCost(
        "densify", 2, gg.grid + f.ctas, g_waves + f.waves,
        g_bytes + f.hbm_bytes, f.fmas, f.flops, g_us + f.predicted_us)
    return SpGEMMCost(sp, fused, de)


def _densest(crs: CRS, width: int) -> int:
    """The most non-zeros of one row in one window of ``width`` columns
    (a round window, or a section). Memoized on the operand, which is
    treated as immutable once priced (as ``ops._incrs_of`` treats it): an
    ``auto`` call prices the same operands again."""
    memo = vars(crs).setdefault("_densest", {})
    if width not in memo:
        if not crs.nnz:
            memo[width] = 1
        else:
            n_win = max(1, -(-crs.shape[1] // width))
            row_of = np.repeat(np.arange(crs.shape[0], dtype=np.int64),
                               np.diff(crs.row_ptr).astype(np.int64))
            g = row_of * n_win + crs.col_idx.astype(np.int64) // width
            memo[width] = max(1, int(np.bincount(g).max()))
    return memo[width]


def spgemm_cost_for(a: CRS, bt: CRS, *, rounds: int = 128,
                    section: int = 256) -> SpGEMMCost:
    """``spgemm_cost`` with the operands' own round rmax and section smax
    (rows padded as the engines pad them: 128 for index matching and
    condense)."""
    m, k = a.shape
    n = bt.shape[0]
    rmax = max(_densest(a, rounds), _densest(bt, rounds))
    n_sections = max(1, -(-k // section))
    return spgemm_cost(-(-m // 128) * 128, -(-n // 128) * 128, k,
                       rounds=rounds, n_rounds=max(1, -(-k // rounds)),
                       rmax_a=rmax, rmax_b=rmax, section=section,
                       n_sections=n_sections,
                       smax_a=_densest(a, section),
                       smax_b=_densest(bt, section))


__all__ = ["SMS", "HopperRates", "RATES", "FusedKernelCost",
           "fused_spmm_cost", "MatchedKernelCost", "index_match_cost",
           "SpGEMMCost", "spgemm_cost", "spgemm_cost_for"]
