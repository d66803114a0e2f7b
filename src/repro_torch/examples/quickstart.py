"""Quickstart: the paper's two contributions in five minutes, on the card.

The port of ``examples/quickstart.py``:

1. InCRS: random access into a row-stored sparse matrix at about b/2 + 1
   memory accesses instead of CRS's about N*D/2 (host models, no card).
2. The synchronized-mesh SpMM: Algorithm 2 is exact, the cycle models of
   the three designs, and the kernels behind one front door: ``ops.spmm``
   dispatches every kernel family on the operand format, and
   ``sparse.SparseSpec`` / ``sparse.Linear`` move a layer from dense to
   fused InCRS to row-sharded InCRS by changing only the spec.

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart
     PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..core.bsr import BSR
from ..core.incrs import InCRS
from ..core.mesh_sim import (conventional_mm_latency, fpic_latency,
                             node_alg2, sync_mesh_latency)
from ..data.datasets import DatasetSpec, synthesize
from ..kernels import ops
from ..launch.mesh import make_mesh
from ..sparse import Linear, SparseSpec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:<i> or cpu)")
    args = ap.parse_args(argv)
    dev = ops.resolve_device(args.device)

    # ---- 1. InCRS random access -------------------------------------
    spec = DatasetSpec("demo", 64, 2048, 0.04)
    crs = synthesize(spec, seed=0)
    inc = InCRS.from_crs(crs)
    rng = np.random.default_rng(0)
    ma_crs = ma_inc = 0
    for _ in range(200):
        i, j = int(rng.integers(64)), int(rng.integers(2048))
        v1, a1 = crs.locate(i, j)
        v2, a2 = inc.locate(i, j)
        if v1 != v2:
            raise RuntimeError(f"locate({i}, {j}): CRS {v1}, InCRS {v2}")
        ma_crs += a1
        ma_inc += a2
    print(f"[InCRS] avg accesses/locate: CRS {ma_crs/200:.1f} -> "
          f"InCRS {ma_inc/200:.1f}  ({ma_crs/ma_inc:.1f}x fewer)")
    print(f"[InCRS] storage ratio (CRS/InCRS): {inc.storage_ratio():.3f}")

    # ---- 2. Algorithm 2 is exact ------------------------------------
    ai, av, _ = crs.get_row(3)
    bi, bv, _ = crs.get_row(7)
    dot, cycles, occ = node_alg2(ai, av, bi, bv, rounds=32)
    dense = crs.to_dense()
    if abs(dot - dense[3] @ dense[7]) >= 1e-6:
        raise RuntimeError("Algorithm 2's dot product is not exact")
    print(f"[Alg2] exact sparse dot in {cycles} cycles "
          f"(max buffer occupancy {occ} <= R=32)")

    # ---- 3. Cycle-level design comparison ---------------------------
    sync = sync_mesh_latency(crs, crs, mesh=64).cycles
    fpic = fpic_latency(crs, crs, k_fpic=8).cycles
    conv = conventional_mm_latency(64, 64, 2048, mesh=96).cycles
    print(f"[mesh] A@A^T latency: sync {sync}  fpic(sameBW) {fpic}  "
          f"conventional {conv} cycles")

    # ---- 4. The kernels: ops.spmm dispatches every family -----------
    out = ops.spmm(crs, crs, rounds=128, device=dev).cpu().numpy()
    ref = dense.astype(np.float32) @ dense.astype(np.float32).T
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1)
    print(f"[{dev.type}] spmm(crs, crs) (index matching) rel err {err:.2e}")

    w = rng.normal(size=(256, 256)).astype(np.float32)
    bsr = BSR.from_dense(np.where(rng.random((256, 256)) < 0.5, w, 0),
                         (128, 128))
    x = rng.normal(size=(256, 64)).astype(np.float32)
    y = ops.spmm(bsr, torch.from_numpy(x).to(dev), device=dev)
    y = y.cpu().numpy()
    err = np.abs(y - bsr.to_dense() @ x).max()
    print(f"[{dev.type}] spmm(bsr, b) (prefix-counter steered) abs err "
          f"{err:.2e}")

    # ---- 5. One layer, three data paths: change ONLY the SparseSpec.
    d_in, d_out = 128, 256
    wl = rng.normal(size=(d_in, d_out)).astype(np.float32)
    mask = np.abs(wl) >= np.quantile(np.abs(wl), 0.9)   # keep the top 10 %
    wl = np.where(mask, wl, 0.0)
    xb = torch.from_numpy(rng.normal(size=(8, d_in)).astype(np.float32))
    base = SparseSpec("incrs", mask=mask)
    specs = {
        "dense": SparseSpec("dense", mask=mask),
        "incrs (fused kernel)": base,
        "incrs (row-sharded)": dataclasses.replace(base,
                                                   mesh=make_mesh(1, dev)),
    }
    ys = {}
    for name, spec in specs.items():
        lin = Linear.from_dense(wl, spec, device=dev)      # ONE constructor
        with torch.no_grad():
            ys[name] = lin(xb.to(dev)).cpu().numpy()       # ONE apply
    ref_y = xb.numpy() @ wl
    for name, yv in ys.items():
        print(f"[spec]  {name:22s} max |err| vs x@W: "
              f"{np.abs(yv - ref_y).max():.2e}")
    if not np.array_equal(ys["incrs (fused kernel)"],
                          ys["incrs (row-sharded)"]):
        raise RuntimeError("the row-sharded layer is not bitwise the fused "
                           "one")
    print("quickstart OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
