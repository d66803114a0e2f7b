"""SpMM algorithms at the paper's abstraction level.

Host-side (numpy) algorithms with memory-access accounting — these drive the
paper-table benchmarks — plus the sorted-index merge ("index matching",
Alg. 1) that each node of the systolic meshes performs, which the cycle
simulators in ``mesh_sim.py`` build on. The port's own copy of
``repro.core.spmm``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .crs import CRS
from .incrs import InCRS


# ----------------------------------------------------------------------
# SpMM with column-order access to the second operand (paper §II/§III).
def spmm_colaccess(a: CRS, b, trace: Optional[List[int]] = None
                   ) -> Tuple[np.ndarray, int]:
    """C = A @ B where A is row-accessed CRS and B (CRS *or* InCRS, both
    row-stored) must be accessed in column order — the paper's problem
    setting. Returns (C, total_memory_accesses_on_B).

    Each column of B is gathered once per SpMM (not once per output element);
    this matches the paper's experiment, which measures the column-gather
    traffic of the second operand.
    """
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims differ: {a.shape} @ {b.shape}")
    c = np.zeros((m, n), dtype=np.result_type(a.values.dtype, np.float64))
    total_ma = 0
    for j in range(n):
        col, ma = b.get_column(j, trace)
        total_ma += ma
        # Row-order pass over A (identical cost for CRS/InCRS; not the
        # quantity under study).
        for i in range(m):
            s, e = a.row_ptr[i], a.row_ptr[i + 1]
            idx = a.col_idx[s:e]
            c[i, j] = np.dot(a.values[s:e], col[idx])
    return c, total_ma


# ----------------------------------------------------------------------
# Index-matching sparse dot product (Alg. 1) — one mesh node's job.
def index_match_dot(a_idx: np.ndarray, a_val: np.ndarray,
                    b_idx: np.ndarray, b_val: np.ndarray
                    ) -> Tuple[float, int]:
    """Sorted-merge intersection of two sparse vectors.

    Returns (dot, cycles) where cycles counts Alg. 1 iterations: one operand
    pair examined per cycle, advancing i, j, or both — exactly the FPIC node
    model (consume-on-match is 1 cycle too).
    """
    i = j = 0
    acc = 0.0
    cycles = 0
    while i < len(a_idx) and j < len(b_idx):
        cycles += 1
        ai, bj = a_idx[i], b_idx[j]
        if ai == bj:
            acc += float(a_val[i]) * float(b_val[j])
            i += 1
            j += 1
        elif ai > bj:
            j += 1
        else:
            i += 1
    return acc, cycles


def spmm_index_match(a: CRS, bt: CRS) -> Tuple[np.ndarray, np.ndarray]:
    """C = A @ Bᵀ via per-(i,j) index-matching (both operands row-stored —
    the A×Aᵀ setting of the paper's §V-C experiments).

    Returns (C, cycles) with cycles[i, j] = merge iterations of node (i, j).
    """
    m = a.shape[0]
    n = bt.shape[0]
    if a.shape[1] != bt.shape[1]:
        raise ValueError(
            f"inner dims differ: {a.shape} vs B^T {bt.shape}")
    c = np.zeros((m, n))
    cyc = np.zeros((m, n), dtype=np.int64)
    rows_a = [a.get_row(i)[:2] for i in range(m)]
    rows_b = [bt.get_row(j)[:2] for j in range(n)]
    for i in range(m):
        ai, av = rows_a[i]
        for j in range(n):
            bi, bv = rows_b[j]
            c[i, j], cyc[i, j] = index_match_dot(ai, av, bi, bv)
    return c, cyc
