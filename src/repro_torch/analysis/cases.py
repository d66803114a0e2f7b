"""Seeded shape cases of every kernel wrapper: what ``analysis.proofs``
launches on the card.

The counterpart of ``repro.analysis.grid_interp.GEOMETRIES``. JAX proves
each Pallas body on one small geometry by interpreting its source; the
port's kernels are CUDA, so each property is checked by launching them,
and one geometry a kernel is not enough: the faults the proofs look for
(a write past the output, an element never written, a ring that slips at
one, two or ``stages`` trips) show only at the shapes that reach them. So
each wrapper of ``launch_check.WRAPPERS`` gets cases that cover, by
family:

* InCRS (the three orders, on the same operands): ragged M, N and K
  (sections of 100 columns), empty rows and empty sections, an all-zero
  operand, smax 1 and the largest smax the order's shared memory takes,
  the stripes' two-deep staging and the pipelined order's TMA ring at 1,
  2, ``stages`` and ``stages`` + 1 trips, each of its instances;
* the gather: the same edges, its tile and general instances;
* index matching and condense: rounds of one slot, rmax 1, rmax = R, A
  and B of other shapes, ragged M and N, empty rows and rounds, a B row
  that repeats an index (summed by shared-memory atomics), the ring at 1,
  2, ``stages`` and ``stages`` + 1 trips and the general instance;
* merge: one round, a plane off a multiple of 4, the ring's trips and the
  general instance;
* BSR and dense: N = 1 and N = 129, every instance (the general BSR
  kernel's four row splits, the bf16 tile widths), a split-K whose every
  partition has one K tile, the ring at 1, 2, ``stages`` and ``stages`` +
  1 trips, empty block rows, an all-zero operand;
* flash attention: sq != sk, lengths off the tiles, a window that skips
  whole key tiles, GQA groups 1, 4, 7 and 10, head dims 64, 128, 192 and
  256 (with the soft cap) in f32 and bf16, the bf16 kernel's K/V ring at
  1, 2, ``stages`` and ``stages`` + 1 trips;

and ``chip_smoke.py``'s fixed edge operands, by name (``edge_*``). Every
instance of every ``.cu`` dispatch is launched by some case: the instances
are read from each source (``dispatch_instances``) in the form of
``launch_check``'s ``instance`` rule, and ``uncovered`` lists any that no
case reaches. Inputs are numpy arrays drawn from a seed; a case carries
the wrapper's static arguments, the launch shape ``launch_check`` reads,
and, where the rule would not pick it, the geometry it forces.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from ..kernels import _build
from ..kernels import bsr_spmm as _bsr
from ..kernels import dense_mm as _dense
from ..kernels import flash_attention as _flash
from ..kernels import incrs_gather as _gather
from ..kernels import incrs_spmm as _incrs
from ..kernels import index_match_spmm as _im
from . import launch_check

F32, BF16 = torch.float32, torch.bfloat16
INCRS = ("incrs_spmm", "incrs_spmm_reuse", "incrs_spmm_pipelined")
_ORDER = {"incrs_spmm": "expand", "incrs_spmm_reuse": "reuse",
          "incrs_spmm_pipelined": "pipelined"}
# Each wrapper's source under csrc/ (the sanitizer runs one family each).
SOURCE = {"incrs_spmm": "incrs_spmm", "incrs_spmm_reuse": "incrs_spmm",
          "incrs_spmm_pipelined": "incrs_spmm",
          "incrs_gather": "incrs_gather",
          "index_match_spmm": "index_match", "spgemm_condense": "index_match",
          "spgemm_merge": "index_match", "dense_mm": "dense_mm",
          "bsr_spmm": "bsr_spmm", "flash_attention": "flash_attention"}
FAMILIES = tuple(dict.fromkeys(SOURCE.values()))

TOL_F32 = 1e-5        # max|kernel - plain| <= TOL_F32 * max|plain|
TOL_BF16 = 1e-2       # bf16 outputs, held row by row (flash.worst_row_error)
# The stripes' cp.async staging of the three InCRS orders is two deep.
STRIPE_STAGES = 2
FLASH_STAGES = 2      # the bf16 flash kernel's K/V ring
ATOMIC_REPEAT = ("a B row repeats an index three times in a round: the "
                 "ring and the general instance add repeats by "
                 "shared-memory atomics in no fixed order "
                 "(index_match.cu build_window), so a repeat is held "
                 "within the tolerance, not bitwise")


@dataclasses.dataclass
class Case:
    """One launch of ``wrapper`` to hold against its plain version.

    ``arrays``: the inputs (numpy, from the seed); ``args``: the
    wrapper's static keywords; ``shape``: ``launch_check``'s launch shape;
    ``geometry``: a launch the rule would not pick (None: the rule's);
    ``trips``: ring trips of the busiest CTA, where the kernel has a ring
    (``stages`` deep); ``tol``: max|kernel - plain| over max|plain|
    (bf16: row by row); ``repeat``: "bitwise", or why a repeat is only
    held within ``tol``."""
    wrapper: str
    name: str
    arrays: Dict[str, np.ndarray]
    args: Dict[str, Any]
    shape: Dict[str, Any]
    geometry: Any = None
    trips: Optional[int] = None
    stages: Optional[int] = None
    tol: float = TOL_F32
    rowwise: bool = False
    repeat: str = "bitwise"

    @property
    def id(self) -> str:
        return f"{self.wrapper}/{self.name}"

    @property
    def source(self) -> str:
        return SOURCE[self.wrapper]

    def launch(self) -> launch_check.Launch:
        return launch_check.launch_of(self.wrapper, self.geometry,
                                      **self.shape)


# ----------------------------------------------------------------------
# Operands.
def stripes(rng, m: int, n_sec: int, smax: int, section: int, *,
            fill: Optional[int] = None, empty_rows=(), empty_secs=(),
            zero: bool = False):
    """(idx, val) InCRS stripes: each (row, section) holds up to ``smax``
    (``fill``: exactly) distinct ascending local columns, -1 pads after."""
    idx = np.full((m, n_sec, smax), -1, np.int32)
    val = np.zeros((m, n_sec, smax), np.float32)
    for r in range(m):
        for s in range(n_sec):
            if r in empty_rows or s in empty_secs:
                continue
            k = fill if fill is not None else int(rng.integers(0, smax + 1))
            k = min(k, smax, section)
            cols = np.sort(rng.choice(section, k, replace=False))
            idx[r, s, :k] = cols
            val[r, s, :k] = 0.0 if zero else rng.standard_normal(k)
    return idx, val


def rounds_operand(rng, rows: int, n_rounds: int, rmax: int, r: int, *,
                   fill: Optional[int] = None, empty_rows=(),
                   empty_rounds=(), zero: bool = False, repeat: int = 0):
    """(idx, val) per-round padded rows: up to ``rmax`` distinct local
    indices in [0, r) a (row, round), -1 pads after; ``repeat`` > 1 makes
    row 0's first index of each round appear that many times."""
    idx = np.full((rows, n_rounds, rmax), -1, np.int32)
    val = np.zeros((rows, n_rounds, rmax), np.float32)
    for i in range(rows):
        for t in range(n_rounds):
            if i in empty_rows or t in empty_rounds:
                continue
            k = fill if fill is not None else int(rng.integers(1, rmax + 1))
            k = min(k, rmax, r)
            idx[i, t, :k] = np.sort(rng.choice(r, k, replace=False))
            val[i, t, :k] = 0.0 if zero else rng.standard_normal(k)
    if repeat > 1:
        for t in range(n_rounds):
            idx[0, t, :repeat] = idx[0, t, 0] if idx[0, t, 0] >= 0 else 0
            val[0, t, :repeat] = rng.standard_normal(repeat)
    return idx, val


def _normal(rng, shape, zero=False) -> np.ndarray:
    if zero:
        return np.zeros(shape, np.float32)
    return rng.standard_normal(shape).astype(np.float32)


# ----------------------------------------------------------------------
# InCRS: the three orders on one set of operands.
def _incrs_trips(wrapper: str, geo, n_sec: int, n: int):
    if wrapper != "incrs_spmm_pipelined":
        return n_sec, STRIPE_STAGES
    bw = _incrs.PIPE_COLS * geo.cols_per_lane
    return n_sec * min(_incrs.PIPE_BLOCKS, -(-n // bw)), geo.stages


def _largest_smax(wrapper: str, m: int, n: int, top: int) -> int:
    """The largest smax (up to ``top``) whose launch of ``wrapper`` on one
    section of smax columns the card's shared memory takes (the rule's
    geometry at M = m rows, N = n; the pipelined ring grows with the
    section)."""
    lo, hi = 1, top
    while lo < hi:
        mid = (lo + hi + 1) // 2
        try:
            _incrs.launch_geometry(wrapper, n, mid, mid, m=m)
            lo = mid
        except ValueError:
            hi = mid - 1
    return lo


def _incrs_cases(rng) -> List[Case]:
    specs = [  # (name, m, n_sec, smax, section, n, stripes kwargs, knobs)
        ("base", 24, 3, 5, 64, 128, {}, None),
        ("ragged_m", 13, 3, 5, 64, 128, {}, None),
        ("ragged_n1", 16, 2, 4, 64, 1, {}, None),
        ("ragged_n130", 16, 2, 4, 64, 130, {}, None),
        ("n260", 16, 2, 4, 64, 260, {}, None),
        ("ragged_k", 16, 3, 7, 100, 96, {}, None),
        ("empty_rows_and_sections", 24, 4, 5, 64, 128,
         {"empty_rows": (0, 5, 23), "empty_secs": (2,)}, None),
        ("all_zero", 16, 2, 4, 64, 128, {"zero": True}, None),
        ("smax1", 24, 3, 1, 64, 128, {"fill": 1}, None),
        ("edge_one_row", 1, 1, 1, 256, 128, {"fill": 1}, None),
    ]
    specs += [(f"trips{t}", 16, t, 4, 64, 64, {}, None) for t in (1, 2, 3)]
    specs += [("trips4", 16, 2, 4, 64, 128, {}, None)]
    out: List[Case] = []
    for name, m, n_sec, smax, section, n, kw, _ in specs:
        idx, val = stripes(rng, m, n_sec, smax, section, **kw)
        b = _normal(rng, (n_sec * section, n), kw.get("zero", False))
        for w in INCRS:
            out += _incrs_case(w, name, idx, val, b, section)
    # the largest smax each order's shared memory takes: one section of
    # that many columns, every slot live
    # (each order its own operand: named apart, not held against the
    # others)
    for w in INCRS:
        n = 64
        smax = _largest_smax(w, 8, n, 8192)
        idx, val = stripes(rng, 8, 1, smax, smax, fill=smax)
        out += _incrs_case(w, f"smax_max_{_ORDER[w]}", idx, val,
                           _normal(rng, (smax, n)), smax)
    # chip_smoke.py's edge operands, at N = 128 and 384
    from ..core.incrs import InCRS
    from ..kernels import ops
    for label, dense in edge_incrs().items():
        ep = ops.prepare_incrs(InCRS.from_dense(dense), pad_rows_to=1,
                               device="cpu")
        kp = ep.n_sections * ep.section
        for n in (128, 384):
            b = np.zeros((kp, n), np.float32)
            b[:dense.shape[1]] = _normal(rng, (dense.shape[1], n))
            for w in INCRS:
                out += _incrs_case(w, f"edge_{label}_n{n}", ep.idx.numpy(),
                                   ep.val.numpy(), b, ep.section)
    # the pipelined order's other instance, and no cluster
    idx, val = stripes(rng, 24, 3, 5, 64)
    b = _normal(rng, (192, 128))
    for name, knobs in (("cpl1", {"cols_per_lane": 1}),
                        ("cluster1", {"cluster": 1})):
        geo = _incrs.pipelined_geometry(24, 128, 5, 64, **knobs)
        out += _incrs_case("incrs_spmm_pipelined", name, idx, val, b, 64,
                           geometry=geo)
    return out


def _incrs_case(wrapper, name, idx, val, b, section, geometry=None):
    m, n_sec, smax = idx.shape
    mp = -(-m // 8) * 8
    n = b.shape[1]
    shape = dict(m=mp, n=n, n_sections=n_sec, smax=smax, section=section)
    if wrapper == "incrs_spmm_pipelined" and n % 4:
        return []                   # TMA reads B in 16-byte rows
    try:
        geo = launch_check.launch_of(wrapper, geometry, **shape).geometry
    except ValueError:
        return []
    trips, stages = _incrs_trips(wrapper, geo, n_sec, n)
    return [Case(wrapper, name, {"idx": idx, "val": val, "b": b},
                 {"section": section, "bm": 8, "bn": max(n, 1)}, shape,
                 geometry, trips, stages)]


# ----------------------------------------------------------------------
def _gather_cases(rng) -> List[Case]:
    out = []
    specs = [("base", 16, 3, 5, 64, {}), ("ragged_m", 13, 3, 5, 64, {}),
             ("ragged_k", 9, 3, 7, 100, {}),
             ("empty_rows_and_sections", 16, 4, 5, 64,
              {"empty_rows": (0, 7), "empty_secs": (1,)}),
             ("all_zero", 8, 2, 4, 64, {"zero": True}),
             ("smax1", 16, 3, 1, 64, {"fill": 1}),
             ("smax_wide", 8, 2, 600, 1024, {}),
             ("edge_one_row", 1, 1, 1, 256, {"fill": 1})]
    ops_ = [(name, *stripes(rng, m, n_sec, smax, section, **kw), section)
            for name, m, n_sec, smax, section, kw in specs]
    from ..core.incrs import InCRS
    from ..kernels import ops
    for label, (da, _) in edge_spgemm().items():
        ep = ops.prepare_incrs(InCRS.from_dense(da), pad_rows_to=1,
                               device="cpu")
        ops_.append((f"edge_{label}", ep.idx.numpy(), ep.val.numpy(),
                     ep.section))
    for name, idx, val, section in ops_:
        m, n_sec, smax = idx.shape
        for inst in (None, "general"):
            geo = None if inst is None else _gather.gather_geometry(
                m, n_sec, smax, section, instance=inst)
            out.append(Case(
                "incrs_gather", name + ("" if inst is None else
                                        "_general"),
                {"idx": idx, "val": val}, {"section": section, "bm": 1},
                dict(m=m, n_sections=n_sec, smax=smax, section=section),
                geo, tol=0.0))
    return out


# ----------------------------------------------------------------------
def _match_trips(geo, n_rounds: int) -> int:
    if geo.instance != "ring":
        return None
    if geo.stripes:
        return geo.chunk
    return n_rounds * -(-geo.tiles // geo.grid)


def _match_cases(rng) -> List[Case]:
    specs = [  # (name, m, n, n_rounds, rmax_a, rmax_b, R, kw_a, kw_b)
        ("base", 40, 50, 3, 4, 3, 32, {}, {}),
        ("rounds_of_one_slot", 24, 30, 4, 1, 1, 1, {}, {}),
        ("rmax1", 24, 30, 3, 1, 1, 32, {}, {}),
        ("rmax_eq_r", 20, 20, 2, 8, 8, 8, {"fill": 8}, {"fill": 8}),
        ("ragged_m", 300, 40, 2, 3, 3, 32, {}, {}),
        ("ragged_n", 1, 130, 2, 3, 3, 32, {}, {}),
        ("empty_rows_and_rounds", 30, 40, 4, 3, 3, 32,
         {"empty_rows": (0, 9), "empty_rounds": (2,)},
         {"empty_rows": (3,), "empty_rounds": (2,)}),
        ("all_zero", 16, 16, 2, 3, 3, 32, {"zero": True}, {"zero": True}),
        ("r300_general", 16, 16, 2, 4, 4, 300, {}, {}),
        ("edge_one_row", 1, 1, 1, 1, 1, 128, {"fill": 1}, {"fill": 1}),
    ]
    specs += [(f"trips{t}", 8, 64, t, 3, 3, 32, {}, {}) for t in (1, 2, 5, 6)]
    out = []
    for name, m, n, t, ra, rb, r, kwa, kwb in specs:
        a = rounds_operand(rng, m, t, ra, r, **kwa)
        b = rounds_operand(rng, n, t, rb, r, **kwb)
        for w in ("index_match_spmm", "spgemm_condense"):
            out += _match_case(w, name, a, b, r)
            if name in ("base", "ragged_n", "empty_rows_and_rounds"):
                out += _match_case(w, name + "_general", a, b, r,
                                   instance="general")
    a = rounds_operand(rng, 12, 3, 4, 32)
    b = rounds_operand(rng, 20, 3, 4, 32, repeat=3)
    for w in ("index_match_spmm", "spgemm_condense"):
        out += _match_case(w, "repeated_index", a, b, 32,
                           repeat=ATOMIC_REPEAT)
        out += _match_case(w, "repeated_index_general", a, b, 32,
                           instance="general", repeat=ATOMIC_REPEAT)
    # chip_smoke.py's edge operands at R = 128
    from ..core.crs import CRS
    from ..kernels import ops
    for label, (da, dbt) in edge_spgemm().items():
        ai, av = ops.prep_rounds(CRS.from_dense(da), 128, pad_rows_to=8,
                                 device="cpu")
        bi, bv = ops.prep_rounds(CRS.from_dense(dbt), 128, pad_rows_to=8,
                                 device="cpu")
        ai, av, bi, bv = (t.numpy() for t in
                          ops.pad_common_rmax(ai, av, bi, bv))
        for w in ("index_match_spmm", "spgemm_condense"):
            out += _match_case(w, f"edge_{label}", (ai, av), (bi, bv), 128)
    # condense's ring at 2, stages and stages + 1 items a CTA
    for t in (2, 5, 6):
        a = rounds_operand(rng, 8, t, 3, 32)
        b = rounds_operand(rng, 64, t, 3, 32)
        out += _match_case("spgemm_condense", f"chunk_trips{t}", a, b, 32,
                           chunk=t)
    return out


def _match_case(wrapper, name, a, b, r, *, instance=None, chunk=None,
                repeat="bitwise"):
    m, t, ra = a[0].shape
    n, _, rb = b[0].shape
    shape = dict(m=m, n=n, n_rounds=t, rmax_a=ra, rmax_b=rb, rounds=r)
    knobs = {k: v for k, v in (("instance", instance), ("chunk", chunk))
             if v is not None}
    try:
        geo = _im.match_geometry(m, n, t, ra, rb, r, wrapper, **knobs)
    except ValueError:
        return []
    return [Case(wrapper, name, {"a_idx": a[0], "a_val": a[1],
                                 "b_idx": b[0], "b_val": b[1]},
                 {"rounds": r, "bm": 1, "bn": 1}, shape,
                 geo if knobs else None, _match_trips(geo, t),
                 geo.stages or None, repeat=repeat)]


def _merge_cases(rng) -> List[Case]:
    from ..spgemm import kernels as _sk
    specs = [("one_round", 1, 32, 64), ("base", 3, 32, 64),
             ("ragged", 3, 130, 70), ("plane_off_4", 3, 3, 5),
             ("large", 4, 160, 128)]
    specs += [(f"trips{t}", t, 32, 64) for t in (1, 2, 4, 5)]
    out = []
    for name, t, m, n in specs:
        s = _normal(rng, (t, m, n))
        for inst in (None, "general"):
            geo = None if inst is None else _sk.merge_geometry(
                m * n, t, instance="general")
            g = geo or _sk.merge_geometry(m * n, t)
            trips = t * -(-g.items // g.grid) if g.instance == "ring" \
                else None
            out.append(Case(
                "spgemm_merge", name + ("" if inst is None else "_general"),
                {"stripes": s}, {"bm": 1, "bn": 1},
                dict(plane=m * n, n_rounds=t), geo, trips,
                g.stages or None, tol=0.0))
    out.append(Case("spgemm_merge", "all_zero",
                    {"stripes": np.zeros((2, 16, 16), np.float32)},
                    {"bm": 1, "bn": 1}, dict(plane=256, n_rounds=2),
                    tol=0.0))
    return out


# ----------------------------------------------------------------------
# BSR and dense: the GEMM core.
def bsr_operand(rng, nbr: int, kb: int, bm: int, bk: int, *, p=0.5,
                empty_rows=(), zero=False):
    """(row_of, col_of, values, row_start) of a block-sparse matrix as
    ``ops.prep_bsr`` hands them to the kernel (an empty block row gets a
    zero tile)."""
    from ..core.bsr import BSR
    from ..kernels import ops
    dense = np.zeros((nbr * bm, kb * bk), np.float32)
    for r in range(nbr):
        if r in empty_rows:
            continue
        cols = [c for c in range(kb) if rng.random() < p] or \
            [int(rng.integers(kb))]
        for c in cols:
            dense[r * bm:(r + 1) * bm, c * bk:(c + 1) * bk] = \
                0.0 if zero else rng.standard_normal((bm, bk))
    bsr = BSR.from_dense(dense, (bm, bk), keep_threshold=-1.0 if zero
                         else 0.0)
    return tuple(t.numpy() for t in ops.prep_bsr(bsr, device="cpu"))


def _gemm_trips(geo, steps: int):
    if not geo.stages:
        return None
    per = -(-steps // geo.splits)
    return per


def _bsr_cases(rng) -> List[Case]:
    specs = [  # (name, nbr, kb, bm, bk, n, dtype, bsr kwargs, knobs)
        ("f32_fast", 3, 4, 64, 16, 64, F32, {}, {}),
        ("f32_fast_empty_rows", 4, 3, 64, 32, 128, F32,
         {"empty_rows": (1, 3)}, {}),
        ("bf16_fast", 3, 3, 64, 64, 64, BF16, {}, {}),
        ("bf16_wide_tile", 2, 2, 64, 64, 264, BF16, {}, {"tile_n": 256}),
        ("general_tm1_n1", 3, 3, 10, 10, 1, F32, {}, {}),
        ("general_tm2_n129", 2, 3, 24, 8, 129, F32, {}, {}),
        ("general_tm4", 2, 2, 50, 10, 64, F32, {}, {}),
        ("general_tm8_ragged", 2, 2, 100, 12, 70, F32,
         {"empty_rows": (0,)}, {}),
        ("general_bf16_n129", 2, 3, 10, 10, 129, BF16, {}, {}),
        ("all_zero", 2, 2, 64, 16, 64, F32, {"zero": True}, {}),
        ("f32_split_k_one_tile", 1, 8, 64, 16, 64, F32, {"p": 1.1},
         {"splits": 8}),
        ("bf16_split_k_one_tile", 1, 4, 64, 64, 64, BF16, {"p": 1.1},
         {"splits": 4}),
    ]
    for t, bk in ((1, 16), (2, 32), (3, 48)):
        specs.append((f"f32_trips{t}", 2, 1, 64, bk, 64, F32, {"p": 1.1},
                      {}))
    for t, bk in ((1, 64), (2, 128), (4, 256), (5, 320)):
        specs.append((f"bf16_trips{t}", 2, 1, 64, bk, 64, BF16,
                      {"p": 1.1}, {}))
    from ..core.bsr import BSR
    from ..kernels import ops
    operands = [(name, *bsr_operand(rng, nbr, kb, bm, bk, **kw), bm, bk,
                 _normal(rng, (kb * bk, n), kw.get("zero", False)), dt,
                 knobs)
                for name, nbr, kb, bm, bk, n, dt, kw, knobs in specs]
    for label, dense, (bm, bk), n in edge_bsr():
        prep = ops.prep_bsr(BSR.from_dense(dense, (bm, bk)), device="cpu")
        operands.append((f"edge_{label}", *(t.numpy() for t in prep), bm,
                         bk, _normal(rng, (dense.shape[1], n)), F32, {}))
    out = []
    for (name, row_of, col_of, values, row_start, bm, bk, b, dt,
         knobs) in operands:
        nbr, n, nnz = len(row_start) - 1, b.shape[1], len(col_of)
        geo = _bsr.gemm_geometry(nbr, bm, bk, n, dt, nnz=nnz, **knobs)
        steps = max(int(np.diff(row_start).max(initial=0)), 1) * \
            (bk // geo.tile_k) if geo.stages else 0
        out.append(Case(
            "bsr_spmm", name,
            {"row_of": row_of, "col_of": col_of, "values": values, "b": b,
             "row_start": row_start},
            {"n_block_rows": nbr, "dtype": dt},
            dict(n_block_rows=nbr, bm=bm, bk=bk, n=n, nnz=nnz, dtype=dt),
            geo if knobs else None, _gemm_trips(geo, steps),
            geo.stages or None, TOL_BF16 if dt == BF16 else TOL_F32,
            rowwise=dt == BF16))
    return out


def _dense_cases(rng) -> List[Case]:
    specs = [  # (name, m, k, n, dtype, knobs, zero)
        ("f32_fast", 130, 64, 128, F32, {}, False),
        ("f32_ragged_m1", 1, 32, 64, F32, {}, False),
        ("bf16_fast", 130, 128, 136, BF16, {}, False),
        ("bf16_wide_tile", 64, 64, 264, BF16, {"tile_n": 256}, False),
        ("general_n1", 33, 20, 1, F32, {}, False),
        ("general_n129", 70, 24, 129, F32, {}, False),
        ("general_k7", 40, 7, 64, F32, {}, False),
        ("general_bf16_n129", 70, 24, 129, BF16, {}, False),
        ("all_zero", 64, 32, 64, F32, {}, True),
        ("f32_split_k_one_tile", 64, 128, 64, F32, {"splits": 8}, False),
        ("bf16_split_k_one_tile", 64, 256, 64, BF16, {"splits": 4}, False),
    ]
    specs += [(f"f32_trips{t}", 64, 16 * t, 64, F32, {}, False)
              for t in (1, 2, 3)]
    specs += [(f"bf16_trips{t}", 64, 64 * t, 64, BF16, {}, False)
              for t in (1, 2, 4, 5)]
    out = []
    for name, m, k, n, dt, knobs, zero in specs:
        a, b = _normal(rng, (m, k), zero), _normal(rng, (k, n), zero)
        geo = _dense.gemm_geometry(m, n, k, dt, **knobs)
        steps = -(-k // geo.tile_k) if geo.stages else 0
        out.append(Case(
            "dense_mm", name, {"a": a, "b": b}, {"dtype": dt},
            dict(m=m, n=n, k=k, dtype=dt), geo if knobs else None,
            _gemm_trips(geo, steps), geo.stages or None,
            TOL_BF16 if dt == BF16 else TOL_F32, rowwise=dt == BF16))
    return out


# ----------------------------------------------------------------------
def _flash_cases(rng) -> List[Case]:
    specs = [  # (name, batch, sq, sk, kv, g, hd, window, cap)
        ("sq_lt_sk", 1, 100, 300, 2, 4, 64, None, None),
        ("sq_gt_sk", 1, 200, 130, 1, 1, 64, None, None),
        ("ragged_len", 2, 77, 77, 1, 7, 128, None, None),
        ("window_skips_tiles", 1, 512, 512, 1, 4, 64, 64, None),
        ("gqa10_hd256_cap", 1, 130, 130, 1, 10, 256, 96, 30.0),
        ("hd192", 1, 96, 96, 2, 2, 192, None, None),
        ("hd128_cap", 1, 160, 160, 2, 4, 128, None, 50.0),
        ("one_query", 1, 1, 1, 1, 1, 64, None, None),
    ]
    specs += [(f"trips{t}", 1, 64 * t, 64 * t, 1, 2, 64, None, None)
              for t in (1, 2, 3)]
    out = []
    for name, batch, sq, sk, kv, g, hd, window, cap in specs:
        q = _normal(rng, (batch, sq, kv, g, hd))
        k = _normal(rng, (batch, sk, kv, hd))
        v = _normal(rng, (batch, sk, kv, hd))
        for dt in (F32, BF16):
            if name.startswith("trips") and dt == F32:
                continue                  # the f32 kernel has no ring
            # the K/V tiles the last query row walks
            last = min(sq, sk) - 1
            lo = 0 if window is None else max(0, last - window + 1)
            trips = (last // _flash.KEY_TILE - lo // _flash.KEY_TILE + 1) \
                if dt == BF16 else None
            out.append(Case(
                "flash_attention", f"{name}_{'bf16' if dt == BF16 else 'f32'}",
                {"q": q, "k": k, "v": v}, {"window": window,
                                           "soft_cap": cap, "dtype": dt},
                dict(batch=batch, sq=sq, sk=sk, kv=kv, g=g, hd=hd, dtype=dt,
                     window=window), None, trips,
                FLASH_STAGES if dt == BF16 else None,
                TOL_BF16 if dt == BF16 else TOL_F32, rowwise=True))
    return out


# ----------------------------------------------------------------------
# chip_smoke.py's fixed edge operands (dense; the cases prep them).
def edge_incrs() -> Dict[str, np.ndarray]:
    """Small InCRS operands that reach each masked edge of the kernels."""
    rng = np.random.default_rng(7)

    def sparse(m, k, d):
        a = rng.uniform(0.5, 1.5, size=(m, k)).astype(np.float32)
        a[rng.random(size=(m, k)) >= d] = 0.0
        return a

    ragged = sparse(203, 1000, 0.05)              # M not a multiple of 8
    empty = sparse(64, 777, 0.05)
    empty[3] = 0.0
    empty[10:20] = 0.0                            # empty rows
    single = np.zeros((50, 1024), np.float32)     # smax = 1
    for r in range(50):
        for s in range(0, 4, 1 + r % 2):
            single[r, s * 256 + rng.integers(256)] = 1.0 + r
    dense_sec = sparse(40, 600, 0.03)
    dense_sec[:, 256:512] = rng.uniform(0.5, 1.5, size=(40, 256))
    k_ragged = sparse(90, 300, 0.1)               # K not a multiple of S
    skewed = sparse(600, 2048, 0.01)              # one row tile holds most
    skewed[:48] = sparse(48, 2048, 0.5)           # of the non-zeros
    return {"m_ragged": ragged, "empty_rows": empty, "smax_1": single,
            "dense_section": dense_sec, "k_ragged": k_ragged,
            "skewed": skewed}


def edge_spgemm() -> Dict[str, tuple]:
    """(A, Bt) dense pairs that reach each masked edge of the sparse x
    sparse kernels."""
    rng = np.random.default_rng(17)

    def sparse(m, k, d):
        a = rng.uniform(-1.5, 1.5, size=(m, k)).astype(np.float32)
        a[rng.random(size=(m, k)) >= d] = 0.0
        return a

    empty = sparse(150, 700, 0.05)
    empty[3] = 0.0
    empty[40:60] = 0.0                            # empty rows
    single = np.zeros((100, 512), np.float32)     # rmax = 1
    for r in range(100):
        for t in range(0, 4, 1 + r % 2):
            single[r, t * 128 + rng.integers(128)] = 1.0 + r
    full = sparse(90, 384, 0.03)
    full[::4, 128:256] = rng.uniform(0.5, 1.5, size=(23, 128))  # rmax = R
    return {"all_zero": (np.zeros((64, 300), np.float32),
                         sparse(40, 300, 0.1)),
            "empty_rows": (empty, empty),
            "rmax_1": (single, single),
            "full_window": (full, full),
            "k_ragged": (sparse(130, 1000, 0.04), sparse(130, 1000, 0.04)),
            "mn_ragged_a_ne_b": (sparse(203, 640, 0.06),
                                 sparse(77, 640, 0.08))}


def _skewed_blocks(rng):
    """A (1024, 4096) operand of 128 x 128 blocks whose eight block-rows
    hold 1, 2, 4, ..., 32 and 0 blocks."""
    a = np.zeros((1024, 4096), np.float32)
    for r, count in enumerate((1, 2, 4, 8, 16, 32, 0, 3)):
        for c in rng.choice(32, size=count, replace=False):
            a[r * 128:(r + 1) * 128, c * 128:(c + 1) * 128] = \
                rng.uniform(-1.5, 1.5, size=(128, 128))
    return a


def edge_bsr() -> list:
    """(label, A, (bm, bk), N): BSR operands that reach each masked
    edge."""
    rng = np.random.default_rng(23)

    def blocky(m, k, bm, bk, d, empty=()):
        keep = rng.random((m // bm, k // bk)) < d
        keep[list(empty)] = False
        a = rng.uniform(-1.5, 1.5, size=(m, k)).astype(np.float32)
        return (a.reshape(m // bm, bm, k // bk, bk) *
                keep[:, None, :, None]).reshape(m, k)

    return [("empty_block_rows", blocky(640, 768, 64, 64, 0.4, (0, 3, 9)),
             (64, 64), 512),
            ("all_empty", np.zeros((256, 384), np.float32), (32, 32), 256),
            ("n_1", blocky(500, 600, 50, 50, 0.5), (50, 50), 1),
            ("n_129", blocky(500, 600, 50, 50, 0.5, (2,)), (50, 50), 129),
            ("rect_32x64", blocky(512, 1024, 32, 64, 0.3, (1,)), (32, 64),
             320),
            # split-K over short runs: 8 block-rows x 1 column tile
            ("split_k", blocky(1024, 4096, 128, 128, 0.3), (128, 128), 128),
            # block-rows of 1 to 32 blocks
            ("skewed", _skewed_blocks(rng), (128, 128), 256)]


_GENERATORS: Dict[str, Callable] = {
    "incrs_spmm": _incrs_cases, "incrs_gather": _gather_cases,
    "index_match": _match_cases, "spgemm_merge": _merge_cases,
    "bsr_spmm": _bsr_cases, "dense_mm": _dense_cases,
    "flash_attention": _flash_cases}
_GEN_OF = {"incrs_spmm": "incrs_spmm", "incrs_spmm_reuse": "incrs_spmm",
           "incrs_spmm_pipelined": "incrs_spmm",
           "incrs_gather": "incrs_gather",
           "index_match_spmm": "index_match",
           "spgemm_condense": "index_match", "spgemm_merge": "spgemm_merge",
           "dense_mm": "dense_mm", "bsr_spmm": "bsr_spmm",
           "flash_attention": "flash_attention"}


@functools.lru_cache(maxsize=None)
def _generated(gen: str, seed: int) -> tuple:
    rng = np.random.default_rng([seed, sorted(_GENERATORS).index(gen)])
    return tuple(_GENERATORS[gen](rng))


def cases(wrappers: Optional[Sequence[str]] = None, *,
          seed: int = 0) -> List[Case]:
    """The cases of ``wrappers`` (default: every wrapper), drawn from
    ``seed``, in a fixed order."""
    wrappers = tuple(launch_check.WRAPPERS if wrappers is None
                     else wrappers)
    bad = set(wrappers) - set(launch_check.WRAPPERS)
    if bad:
        raise ValueError(f"unknown wrappers {sorted(bad)}")
    gens = dict.fromkeys(_GEN_OF[w] for w in wrappers)
    return [c for g in gens for c in _generated(g, seed)
            if c.wrapper in wrappers]


def family_cases(family: str, *, seed: int = 0) -> List[Case]:
    """The cases of every wrapper whose kernels live in ``csrc/<family>``."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; expected one of "
                         f"{FAMILIES}")
    return cases([w for w, s in SOURCE.items() if s == family], seed=seed)


# ----------------------------------------------------------------------
# The instances of each .cu dispatch, in launch_check's token form.
_DISPATCH_PATTERNS = {
    "incrs_spmm": (r"expand_kernel<(?:true|false)>",
                   r"reuse_kernel<\d+>", r"launch_pipelined<\d+>"),
    "incrs_spmm_reuse": (r"reuse_kernel<\d+>",),
    "incrs_spmm_pipelined": (r"launch_pipelined<\d+>",),
    "dense_mm": (r"case (?:F32_FMA|BF16_WGMMA|GENERAL_F32|GENERAL_BF16):",
                 r"kBf16Bk, \d+>"),
    "bsr_spmm": (r"case (?:F32_FMA|BF16_WGMMA|GENERAL_F32|GENERAL_BF16):",
                 r"kBf16Bk, \d+>", r"bsr_kernel<\d+, T>"),
    "flash_attention": (r"launch_f32<\d+>", r"launch_bf16<\d+>"),
}


def dispatch_instances(wrapper: str) -> Set[str]:
    """Every instance ``wrapper``'s ``.cu`` dispatch can launch, as
    ``launch_check``'s ``instance`` rule names them: the ``enum
    Instance`` ids (``launch_check._enum_ids``) of the gather, index
    matching, condense and merge; the template instances and switch cases
    of the others."""
    src = SOURCE[wrapper]
    if src in ("incrs_gather", "index_match"):
        return {f"{k.upper()} = {v}"
                for k, v in launch_check._enum_ids(src).items()}
    text = (_build.CSRC / f"{src}.cu").read_text()
    pats = _DISPATCH_PATTERNS[wrapper]
    if wrapper == "incrs_spmm":
        pats = pats[:1]
    return {m for p in pats for m in re.findall(p, text)}


def launched_instances(cs: Sequence[Case]) -> Dict[str, Set[str]]:
    """{wrapper: the dispatch tokens its cases' launches name}."""
    out: Dict[str, Set[str]] = {}
    for c in cs:
        toks = out.setdefault(c.wrapper, set())
        for t in c.launch().tokens:
            if not t.startswith("tpr != "):
                toks.add(t)
    return out


def uncovered(cs: Optional[Sequence[Case]] = None) -> Dict[str, Set[str]]:
    """{wrapper: instances of its dispatch that no case launches}; empty
    when the cases launch every one."""
    cs = cases() if cs is None else cs
    got = launched_instances(cs)
    out = {}
    for w in dict.fromkeys(c.wrapper for c in cs):
        miss = dispatch_instances(w) - got.get(w, set())
        if miss:
            out[w] = miss
    return out


__all__ = ["Case", "cases", "family_cases", "dispatch_instances",
           "launched_instances", "uncovered", "FAMILIES", "SOURCE",
           "stripes", "rounds_operand", "bsr_operand"]
