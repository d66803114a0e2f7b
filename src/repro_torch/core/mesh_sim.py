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
two packages count the same work.

The latency half is the JAX module's, unchanged: cycle-accurate models of
the three SpMM designs of paper sections IV / V-C, compared on A @ A.T as
in Figs. 4-5. ``conventional_mm_latency`` is the dense systolic mesh
(Fig. 2a: a tile of output takes K cycles whatever the sparsity);
``fpic_latency`` the FPIC design [11] (8x8 units whose nodes merge their
two index streams independently, Alg. 1; a tile ends with its slowest
node, units perfectly load-balanced); ``sync_mesh_latency`` the paper's
synchronized mesh (Fig. 2b, Alg. 2: operands shared along each mesh row
and column move in lockstep, rows and columns re-synchronize every round
of R column indices, so a round costs its longest stream). ``node_alg2``
is Algorithm 2 element by element, and the resource-matching rules are
equations 1-2 and Table V.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .crs import CRS
from .spmm import index_match_dot

R_DEFAULT = 32            # round size / operand-buffer depth (paper IV-B)
FPIC_N = 8                # FPIC unit is fixed 8x8 [11]
W_IDX, W_VAL = 16, 32     # index / value widths in bits (paper V-C)
W_TOT = W_IDX + W_VAL


# ----------------------------------------------------------------------
# Faithful Algorithm 2: one synchronized-mesh node.
def node_alg2(a_idx: Sequence[int], a_val: Sequence[float],
              b_idx: Sequence[int], b_val: Sequence[float],
              rounds: int = R_DEFAULT) -> Tuple[float, int, int]:
    """Run the paper's Alg. 2 verbatim on two sorted sparse vectors.

    The node consumes ONE operand from each stream per cycle (lines 27-28);
    the larger-index operand of a mismatch is buffered (lines 14/25) and the
    smaller one is searched against the buffer when the flag says the buffer
    holds the other matrix's operands (lines 5-9 / 16-20). Buffers reset at
    every round boundary (paper §IV-B "Synchronization").

    Returns ``(dot, cycles, max_buffer_occupancy)``.
    """
    a_idx = list(a_idx); b_idx = list(b_idx)
    n_rounds = 0
    if a_idx or b_idx:
        hi = max(a_idx[-1] if a_idx else 0, b_idx[-1] if b_idx else 0)
        n_rounds = hi // rounds + 1
    c = 0.0
    cycles = 0
    max_occ = 0
    i = j = 0
    for k in range(n_rounds):
        lo, hi = k * rounds, (k + 1) * rounds
        # Round boundary: reset buffer + flag (stale operands provably
        # cannot match anything in later rounds).
        buffer: List[Tuple[int, float]] = []
        flag = None
        while True:
            a_live = i < len(a_idx) and a_idx[i] < hi
            b_live = j < len(b_idx) and b_idx[j] < hi
            if not a_live and not b_live:
                break
            cycles += 1
            if a_live and b_live:
                ai, bj = a_idx[i], b_idx[j]
                if ai == bj:                                  # lines 1-3
                    c += a_val[i] * b_val[j]
                    buffer = []
                    flag = None
                elif ai > bj:                                 # lines 4-14
                    if flag == "A":
                        for (bi_, bv_) in buffer:             # search()
                            if bi_ == bj:
                                c += bv_ * b_val[j]
                                break
                    else:
                        buffer = []
                        flag = "A"
                    buffer.append((ai, a_val[i]))
                else:                                         # lines 15-25
                    if flag == "B":
                        for (bi_, bv_) in buffer:
                            if bi_ == ai:
                                c += bv_ * a_val[i]
                                break
                    else:
                        buffer = []
                        flag = "B"
                    buffer.append((bj, b_val[j]))
                i += 1                                        # line 27
                j += 1                                        # line 28
            elif a_live:
                # B stream exhausted for this round: keep consuming A,
                # matching against buffered B operands.
                if flag == "B":
                    for (bi_, bv_) in buffer:
                        if bi_ == a_idx[i]:
                            c += bv_ * a_val[i]
                            break
                i += 1
            else:
                if flag == "A":
                    for (bi_, bv_) in buffer:
                        if bi_ == b_idx[j]:
                            c += bv_ * b_val[j]
                            break
                j += 1
            max_occ = max(max_occ, len(buffer))
    return c, cycles, max_occ


# ----------------------------------------------------------------------
# Stream-length machinery shared by the latency models.
def _round_lengths(crs: CRS, rounds: int) -> np.ndarray:
    """lengths[i, k] = # non-zeros of row i with column index in round k."""
    n_rounds = max(1, -(-crs.shape[1] // rounds))
    out = np.zeros((crs.shape[0], n_rounds), dtype=np.int32)
    if crs.nnz:
        row_of = np.repeat(np.arange(crs.shape[0]),
                           np.diff(crs.row_ptr).astype(np.int64))
        np.add.at(out, (row_of, crs.col_idx // rounds), 1)
    return out


def _row_lengths(crs: CRS) -> np.ndarray:
    return np.diff(crs.row_ptr).astype(np.int64)


def _row_maxidx(crs: CRS) -> np.ndarray:
    """Largest column index per row (-1 for empty rows)."""
    m = crs.shape[0]
    out = np.full(m, -1, dtype=np.int64)
    for i in range(m):
        s, e = crs.row_ptr[i], crs.row_ptr[i + 1]
        if e > s:
            out[i] = crs.col_idx[e - 1]
    return out


def merge_cycles_matrix(a: CRS, bt: CRS, return_consumed: bool = False):
    """cycles[i, j] of the Alg.-1 merge of A's row i with Bt's row j,
    computed in closed form (validated against ``index_match_dot`` in
    tests/test_mesh_sim.py)::

        A exhausts first (a_max <= b_max):
            cycles = |a| + #{b <= a_max} - matches
        else symmetric.

    With ``return_consumed`` also returns (i_end, j_end): how many A/B
    operands merge (i, j) reads — the input-port traffic of an FPIC node.
    """
    m, n = a.shape[0], bt.shape[0]
    la, lb = _row_lengths(a), _row_lengths(bt)
    am, bm = _row_maxidx(a), _row_maxidx(bt)

    # matches[i, j] via indicator-matrix product (blocked float32).
    k = a.shape[1]
    ai = np.zeros((m, k), dtype=np.float32)
    for i in range(m):
        ai[i, a.col_idx[a.row_ptr[i]:a.row_ptr[i + 1]]] = 1.0
    bi = np.zeros((n, k), dtype=np.float32)
    for j in range(n):
        bi[j, bt.col_idx[bt.row_ptr[j]:bt.row_ptr[j + 1]]] = 1.0
    matches = (ai @ bi.T).astype(np.int64)

    # count(b <= a_max_i) per (i, j) and count(a <= b_max_j).
    cb = np.empty((n, m), dtype=np.int64)       # cb[j, i] = #{b_j <= am_i}
    for j in range(n):
        row = bt.col_idx[bt.row_ptr[j]:bt.row_ptr[j + 1]]
        cb[j] = np.searchsorted(row, am, side="right")
    ca = np.empty((m, n), dtype=np.int64)       # ca[i, j] = #{a_i <= bm_j}
    for i in range(m):
        row = a.col_idx[a.row_ptr[i]:a.row_ptr[i + 1]]
        ca[i] = np.searchsorted(row, bm, side="right")

    a_first = am[:, None] <= bm[None, :]        # A exhausts first (or tie)
    cyc = np.where(a_first,
                   la[:, None] + cb.T - matches,
                   lb[None, :] + ca - matches)
    # empty-stream rows/cols: merge does 0 cycles
    cyc[la == 0, :] = 0
    cyc[:, lb == 0] = 0
    if not return_consumed:
        return cyc.astype(np.int64)
    i_end = np.where(a_first, la[:, None], ca)
    j_end = np.where(a_first, cb.T, lb[None, :])
    dead = (la[:, None] == 0) | (lb[None, :] == 0)
    i_end = np.where(dead, 0, i_end)
    j_end = np.where(dead, 0, j_end)
    return cyc.astype(np.int64), i_end.astype(np.int64), \
        j_end.astype(np.int64)


# ----------------------------------------------------------------------
@dataclasses.dataclass
class LatencyReport:
    cycles: int
    n_tiles: int
    detail: str = ""


def conventional_mm_latency(m: int, n_out: int, k: int,
                            mesh: int) -> LatencyReport:
    """Dense systolic MM: every output tile streams the FULL inner dimension
    (zeros included) — ceil(M/mesh) * ceil(N/mesh) tiles x K cycles, plus a
    one-time 2*(mesh-1) systolic fill/drain."""
    tiles = -(-m // mesh) * (-(-n_out // mesh))
    return LatencyReport(tiles * k + 2 * (mesh - 1), tiles)


def fpic_latency(a: CRS, bt: CRS, k_fpic: int, unit: int = FPIC_N,
                 port_contention: bool = True) -> LatencyReport:
    """FPIC [11]: nodes merge independently; a tile completes at its
    slowest node. Because the unit's 8 row-buffers / 8 column-buffers each
    have one read port while the 64 nodes sit at INDEPENDENT positions of
    their streams (no sharing, unlike the synchronized mesh), a buffer
    serves its 8 nodes one element at a time: the tile additionally takes
    at least max_r sum_j i_end(r, j) cycles (and the column analogue) —
    the paper's "each node reads and compares operands independently ...
    high bandwidth requirement ... buffering limits the mesh size".
    k_fpic units are perfectly load-balanced (the paper's best case:
    single-unit latency / k_fpic)."""
    cyc, i_end, j_end = merge_cycles_matrix(a, bt, return_consumed=True)
    m, n = cyc.shape
    total = 0
    for ti in range(0, m, unit):
        for tj in range(0, n, unit):
            t = int(cyc[ti:ti + unit, tj:tj + unit].max(initial=0))
            if port_contention:
                row_reads = i_end[ti:ti + unit, tj:tj + unit].sum(axis=1)
                col_reads = j_end[ti:ti + unit, tj:tj + unit].sum(axis=0)
                t = max(t, int(row_reads.max(initial=0)),
                        int(col_reads.max(initial=0)))
            total += t
    return LatencyReport(-(-total // k_fpic),
                         (-(-m // unit)) * (-(-n // unit)))


def sync_mesh_latency(a: CRS, bt: CRS, mesh: int,
                      rounds: int = R_DEFAULT) -> LatencyReport:
    """The paper's synchronized mesh. Streams are shared along rows/columns
    and consumed one element per cycle per node; a global barrier at every
    round boundary means round k costs the longest round-k stream among the
    tile's rows and columns::

        L(tile) = sum_k max(max_i la[i, k], max_j lb[j, k])
    """
    la = _round_lengths(a, rounds)          # (M,  n_rounds)
    lb = _round_lengths(bt, rounds)         # (N,  n_rounds)
    m, n = la.shape[0], lb.shape[0]
    total = 0
    for ti in range(0, m, mesh):
        ra = la[ti:ti + mesh]               # rows of this tile stripe
        for tj in range(0, n, mesh):
            rb = lb[tj:tj + mesh]
            per_round = np.maximum(ra.max(axis=0, initial=0),
                                   rb.max(axis=0, initial=0))
            total += int(per_round.sum())
    total += 2 * (mesh - 1)                 # systolic fill/drain (once)
    return LatencyReport(total, (-(-m // mesh)) * (-(-n // mesh)))


# ----------------------------------------------------------------------
# Resource matching (paper section V-C equations 1 / 2 and Table V).
def fpic_units_same_bw(n_synch: int) -> int:
    """Eq. 1: 2*N*W = 2*8*k*W  ->  k = N/8."""
    return max(1, n_synch // FPIC_N)


def fpic_units_same_buffer(n_synch: int) -> int:
    """Eq. 2: N^2 = 2*8^2*k  ->  k = N^2/128."""
    return max(1, n_synch * n_synch // (2 * FPIC_N * FPIC_N))


def conv_mesh_same_bw(n_synch: int) -> int:
    """Table V: N_conv = (W_tot / W_val) * N_synch (dense streams carry no
    index words, so the same wires feed 1.5x more value lanes)."""
    return (W_TOT * n_synch) // W_VAL


def bandwidth_kb_per_cycle(n_synch: int) -> float:
    """2 streams x N lanes x (16+32)-bit operands, in kilobits/cycle."""
    return 2 * n_synch * W_TOT / 1024.0


def buffer_kb(n_synch: int, rounds: int = R_DEFAULT) -> float:
    """N^2 operand buffers, ``rounds`` deep, (16+32)-bit entries, in kB."""
    return n_synch * n_synch * rounds * W_TOT / 8.0 / 1024.0


# ----------------------------------------------------------------------
# Cost models of the port's kernels on the H100.
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
    waves = _waves(ctas, _im.assumed_ctas(geo))
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


__all__ = ["R_DEFAULT", "FPIC_N", "W_IDX", "W_VAL", "W_TOT", "node_alg2",
           "merge_cycles_matrix", "LatencyReport", "conventional_mm_latency",
           "fpic_latency", "sync_mesh_latency", "fpic_units_same_bw",
           "fpic_units_same_buffer", "conv_mesh_same_bw",
           "bandwidth_kb_per_cycle", "buffer_kb",
           "SMS", "HopperRates", "RATES", "FusedKernelCost",
           "fused_spmm_cost", "MatchedKernelCost", "index_match_cost",
           "SpGEMMCost", "spgemm_cost", "spgemm_cost_for"]
