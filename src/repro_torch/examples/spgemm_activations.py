"""SpGEMM demo: top-k-sparsified activations times sparse InCRS weights.

The port of ``examples/spgemm_activations.py``. After a top-k (or ReLU)
nonlinearity the activation matrix is itself sparse, so activations x
weights is sparse x sparse. On the plan–execute API that is one spec
change, ``rhs_format="incrs"``, from the dense right-hand side path:

    SparseSpec("crs", rounds=128)                      # A sparse, B dense
    SparseSpec("crs", rounds=128, rhs_format="incrs")  # A sparse, B sparse

The demo also prints the engine ``ops.spmm(..., variant="auto")`` picks
from the card's cost model (``core.mesh_sim.spgemm_cost_for``, priced by
``kernels.autotune.pick_spgemm_engine``) with each engine's predicted µs,
and the output-density estimate that decides a CRS or a dense output in
``spgemm.spgemm``.

Run: PYTHONPATH=src python -m repro_torch.examples.spgemm_activations
     PYTHONPATH=src python -m repro_torch.examples.spgemm_activations \\
         --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import spgemm
from ..core import mesh_sim
from ..core.crs import CRS
from ..core.incrs import InCRS
from ..kernels import autotune, ops
from ..sparse import SparseSpec, plan_for_operand

TOL = 1e-4            # max|C - C64| <= TOL * max(|C64|, 1)


def topk_sparsify(x: np.ndarray, k: int) -> np.ndarray:
    """Keep the k largest-magnitude entries per row, zero the rest."""
    thresh = np.partition(np.abs(x), -k, axis=1)[:, -k:-k + 1]
    return np.where(np.abs(x) >= thresh, x, 0.0)


def _rel_err(out, ref: np.ndarray) -> float:
    out = out.cpu().numpy() if hasattr(out, "cpu") else np.asarray(out)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1.0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    args = ap.parse_args(argv)
    dev = ops.resolve_device(args.device)
    rng = np.random.default_rng(0)
    batch, d_model, d_ff = 64, 1024, 256

    # sparse weights (a pruned FFN projection stored as W^T, rows index
    # output features) and sparse activations (top-5 %)
    w = rng.normal(size=(d_ff, d_model)).astype(np.float32)
    w = np.where(rng.random(w.shape) < 0.08, w, 0.0)
    acts = rng.normal(size=(batch, d_model)).astype(np.float32)
    acts = topk_sparsify(acts, k=d_model // 20)

    a = CRS.from_dense(acts)
    wt = InCRS.from_crs(CRS.from_dense(w))
    ref = acts.astype(np.float64) @ w.T.astype(np.float64)

    bound = plan_for_operand(a, SparseSpec("crs", rounds=128,
                                           rhs_format="incrs"), device=dev)
    err = _rel_err(bound(wt), ref)
    print(f"[plan]  SparseSpec('crs', rhs_format='incrs'): "
          f"{batch}x{d_model} (5% acts) @ {d_ff}x{d_model}.T (8% w), "
          f"rel err {err:.2e}")
    if err > TOL:
        raise SystemExit(f"plan result off by {err:.2e} > {TOL}")

    cost = mesh_sim.spgemm_cost_for(a, wt.crs, rounds=128)
    pick = autotune.pick_spgemm_engine(cost)
    us = cost.predicted_us()
    auto_err = _rel_err(ops.spmm(a, wt, rounds=128, device=dev), ref)
    print(f"[auto]  ops.spmm(CRS, InCRS) engine={pick} (predicted µs on the "
          f"H100: reference={us['reference']:.1f} condense_merge="
          f"{us['condense_merge']:.1f} densify={us['densify']:.1f}), rel "
          f"err {auto_err:.2e}")
    if auto_err > TOL:
        raise SystemExit(f"auto result off by {auto_err:.2e} > {TOL}")

    thin_acts = CRS.from_dense(topk_sparsify(
        rng.normal(size=(batch, d_model)).astype(np.float32), 8))
    thin_w = CRS.from_dense(np.where(rng.random(w.shape) < 0.01, w, 0.0))
    c, est = spgemm.spgemm(thin_acts, thin_w, rounds=128, device=dev)
    kind = "CRS" if isinstance(c, CRS) else "dense"
    dens = (c.nnz / (c.shape[0] * c.shape[1])) if isinstance(c, CRS) \
        else float((c != 0).float().mean())
    print(f"[est]   8-nnz acts x 1% weights: estimated density {est:.3f} "
          f"-> {kind} output (actual {dens:.3f})")
    c2, est2 = spgemm.spgemm(a, wt.crs, rounds=128, device=dev)
    kind2 = "CRS" if isinstance(c2, CRS) else "dense"
    print(f"[est]   5% acts x 8% weights:    estimated density {est2:.3f} "
          f"-> {kind2} output")
    print(f"spgemm_activations OK on {dev}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
