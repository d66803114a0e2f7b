"""Serving launcher: the paper's SpMM workload through ``SpMMEngine``.

One fixed sparse operand (InCRS), a queue of dense right-hand sides, on one
device (CUDA unless ``--device cpu``):

  python -m repro_torch.launch.serve --spmm --workload incrs-docword \
      --scale 1.0

Without ``--workload`` the operand is a synthetic ``--spmm-rows`` x
``--spmm-cols`` matrix of ``--spmm-density``. Every result is checked
against the dense float64 product on the host; a wrong one fails the run.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _main_spmm(args) -> int:
    from ..configs.paper_spmm import WORKLOADS
    from ..core.incrs import InCRS
    from ..data.datasets import DatasetSpec, scaled, synthesize
    from ..serve.engine import SpMMEngine, SpMMRequest

    if args.workload is not None:
        wl = WORKLOADS[args.workload]
        spec = scaled(wl.dataset, args.scale) if args.scale != 1.0 \
            else wl.dataset
        section, block = wl.section, wl.block
    else:
        spec = DatasetSpec("serve", args.spmm_rows, args.spmm_cols,
                           args.spmm_density)
        section, block = 256, 32
    a = synthesize(spec, seed=args.seed)
    eng = SpMMEngine(InCRS.from_crs(a, section, block),
                     max_wave_cols=args.spmm_max_wave_cols,
                     device=args.device,
                     continuous=not args.spmm_wave_barrier,
                     latency_budget_us=args.spmm_latency_budget_us)
    rng = np.random.default_rng(args.seed)
    reqs = [SpMMRequest(i, rng.normal(
        size=(spec.n, args.spmm_batch_cols)).astype(np.float32))
        for i in range(args.n_requests)]
    t0 = time.time()
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    dt = time.time() - t0
    s = eng.stats_summary()
    print(f"spmm A={spec.m}x{spec.n} d={spec.density} nnz={a.nnz} "
          f"format={args.format} (single-device {eng.device}, {s['mode']}): "
          f"served {len(done)} requests / {eng.stats['cols']} cols in "
          f"{dt:.2f}s, waves={eng.stats['waves']}")
    print(f"  {s['requests_per_s']:.1f} req/s, latency "
          f"p50={s['latency_ms']['p50']:.1f}ms "
          f"p99={s['latency_ms']['p99']:.1f}ms, prep overlap "
          f"{s['prep_overlap_fraction']:.0%}")
    ref = a.to_dense().astype(np.float64)
    worst = 0.0
    for r in done:
        want = ref @ r.b.astype(np.float64)
        err = float(np.abs(r.out - want).max())
        worst = max(worst, err / max(float(np.abs(want).max()), 1e-30))
    print(f"  max |err| / max|C| vs dense float64 oracle: {worst:.2e}")
    if len(done) != len(reqs) or worst > 1e-4:
        print("  FAILED: a result is missing or off by more than "
              "1e-4 * max|C|", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    from ..configs.paper_spmm import WORKLOADS

    ap = argparse.ArgumentParser()
    ap.add_argument("--spmm", action="store_true",
                    help="serve the paper's SpMM workload (the only mode "
                         "ported so far)")
    ap.add_argument("--format", default="incrs", choices=("incrs",),
                    help="kernel family of the served operand")
    ap.add_argument("--workload", default=None, choices=sorted(WORKLOADS),
                    help="a Table II / IV dataset (default: the synthetic "
                         "--spmm-rows x --spmm-cols operand)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="shrink --workload's rows and columns by this")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda or cpu)")
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spmm-max-wave-cols", type=int, default=512,
                    help="hard wave cap; the cost model chooses widths "
                         "up to it")
    ap.add_argument("--spmm-wave-barrier", action="store_true",
                    help="strict FIFO waves, no prep/compute overlap")
    ap.add_argument("--spmm-latency-budget-us", type=float, default=None,
                    help="per-wave latency target for the cost model")
    ap.add_argument("--spmm-rows", type=int, default=256)
    ap.add_argument("--spmm-cols", type=int, default=1024)
    ap.add_argument("--spmm-density", type=float, default=0.03)
    ap.add_argument("--spmm-batch-cols", type=int, default=64)
    args = ap.parse_args(argv)
    if not args.spmm:
        raise SystemExit("LM serving is not ported yet (ROADMAP queue 1 "
                         "item 12); pass --spmm")
    return _main_spmm(args)


if __name__ == "__main__":
    sys.exit(main())
