"""SpGEMM entry points: prep -> condense -> merge, plus the output-density
estimate.

The port of ``repro.spgemm.pipeline``. ``condense_merge_prepped`` takes
both operands in per-round padded form (``ops.prep_rounds`` output), pads
them to a common rmax exactly as ``ops.index_match_prepped`` does (which
is what makes the two-pass result bitwise equal to the fused kernel) and
runs the two kernels. On the card it first refuses a stripe array larger
than the memory the device can still hand out, before allocating it.

``spgemm`` is the standalone entry for CRS × CRS: the output-density
estimator chooses a CRS result (on the host) or a dense one (a tensor on
the device).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..core.crs import CRS
from ..core.incrs import InCRS
from ..kernels import ops as _ops
from .kernels import spgemm_condense, spgemm_merge

#: estimated output density below which ``spgemm(output="auto")`` returns CRS
SPARSE_OUTPUT_THRESHOLD = 0.25


def _check_stripe_memory(n_rounds: int, m: int, n: int,
                         device: torch.device) -> None:
    """Refuse, before allocating, an f32 (n_rounds, M, N) stripe array
    larger than the device's free memory plus what torch holds cached."""
    if device.type != "cuda":
        return
    need = 4 * n_rounds * m * n
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - \
        torch.cuda.memory_allocated(device)
    if need > free:
        raise RuntimeError(
            f"condense_merge: the ({n_rounds}, {m}, {n}) f32 stripe array "
            f"needs {need / 1e9:.2f} GB, over the {free / 1e9:.2f} GB free "
            f"on {device}; use variant='reference' (no stripes) or a "
            f"larger rounds window")


def condense_merge_prepped(ai, av, bi, bv, *, rounds: int = 128,
                           bm: int = 128, bn: int = 128,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """C = A @ B.T from PRE-PREPPED per-round operands, in two passes.

    Pads both sides to a common rmax, condenses every round window into
    its partial stripe, then merges the stripes in ascending round order.
    Returns the PADDED output; callers trim to the real (M, N). Bitwise
    equal to ``index_match_prepped`` on identical inputs.
    """
    if out_dtype is None:
        out_dtype = torch.promote_types(av.dtype, bv.dtype)
    ai, av, bi, bv = _ops.pad_common_rmax(ai, av, bi, bv)
    _check_stripe_memory(ai.shape[1], ai.shape[0], bi.shape[0], ai.device)
    stripes = spgemm_condense(ai, av, bi, bv, rounds=rounds, bm=bm, bn=bn)
    return spgemm_merge(stripes, bm=bm, bn=bn, out_dtype=out_dtype)


def estimate_output_density(a: CRS, bt: CRS, rounds: int = 128) -> float:
    """Estimated density of C = A @ Bt.T from per-round nnz counts alone.

    Within round window t a non-zero of A row i meets a non-zero of Bt
    row j iff they share a slot; modelling slots as uniform over R, the
    expected matched pairs for (i, j) are sum_t ca[i,t]*cb[j,t]/R, and
    P[C_ij != 0] ~= 1 - exp(-pairs), aggregated over all (i, j) without
    materializing the M x N pair matrix.
    """
    m = a.shape[0]
    if m == 0 or bt.shape[0] == 0:
        return 0.0
    ca = _ops.round_groups(a, rounds)[1].astype(np.float64)
    cb = _ops.round_groups(bt, rounds)[1].astype(np.float64)
    # E[pairs] summed over all (i, j) = sum_t (sum_i ca) * (sum_j cb) / R
    pairs = float((ca.sum(axis=0) * cb.sum(axis=0)).sum()) / rounds
    mean_pairs = pairs / (m * bt.shape[0])
    return float(1.0 - np.exp(-mean_pairs))


def spgemm(a: CRS, b: Union[CRS, InCRS], *, rounds: int = 128,
           bm: int = 128, bn: int = 128, output: str = "auto",
           sparse_threshold: float = SPARSE_OUTPUT_THRESHOLD, device=None
           ) -> Tuple[Union[CRS, torch.Tensor], float]:
    """C = A @ B.T for sparse A and sparse B (row-stored) through condense
    + merge on ``device``, returning ``(C, estimated_density)``. C is a
    host CRS when the estimator predicts a sparse output
    (``output="auto"``) or as forced by ``output="crs"``, else the dense
    (M, N) tensor on the device (``output="dense"``).
    """
    if output not in ("auto", "crs", "dense"):
        raise ValueError(f"output must be 'auto', 'crs' or 'dense', "
                         f"got {output!r}")
    bt = b.crs if isinstance(b, InCRS) else b
    _ops.check_inner(a, bt)
    est = estimate_output_density(a, bt, rounds)
    ai, av = _ops.prep_rounds(a, rounds, pad_rows_to=bm, device=device)
    bi, bv = _ops.prep_rounds(bt, rounds, pad_rows_to=bn, device=device)
    out = condense_merge_prepped(ai, av, bi, bv, rounds=rounds, bm=bm,
                                 bn=bn)
    dense = out[:a.shape[0], :bt.shape[0]]
    if output == "crs" or (output == "auto" and est < sparse_threshold):
        return CRS.from_dense(dense.cpu().numpy()), est
    return dense, est
