"""End-to-end driver for the paper's own workload on the port: batched
SpMM serving.

The port of ``examples/spmm_serve.py``. A queue of requests (multiply the
sparse dataset A by incoming dense panels B) is served through
``serve.SpMMEngine``: A is prepped to InCRS section stripes once, then
every wave runs the fused InCRS kernel, continuous and wave-barrier. Two
baselines run the same requests: the two-pass pipeline (the gather kernel
densifies A, then the dense kernel) and the dense kernel on a dense A.
Every request, and both baselines, are held against the float64 product.

The serving times are host wall times up to the results on the host; the
baselines are timed by CUDA events on the card (the host clock on the
CPU), and the card's name and power limit are printed beside them.

Run: PYTHONPATH=src python -m repro_torch.examples.spmm_serve [--requests 8]
     PYTHONPATH=src python -m repro_torch.examples.spmm_serve \\
         --device cpu --scale 0.06
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from ..benchmarks.serve_bench import device_record
from ..configs.paper_spmm import WORKLOADS
from ..core.incrs import InCRS
from ..data.datasets import scaled, synthesize
from ..kernels import ops
from ..serve.engine import WAVE_QUANTUM, SpMMEngine, SpMMRequest

TOL = 1e-4           # max|C - C64| <= TOL * max|C64|, per request


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="incrs-docword",
                    choices=sorted(WORKLOADS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-cols", type=int, default=64)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="1.0 serves the dataset at its published size")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap.parse_args(argv)


def _timed_ms(fn, dev: torch.device):
    """(result, ms) of one call of ``fn``: CUDA events on the card, the
    host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _rel_err(got, want64: np.ndarray) -> float:
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want64).max()) / max(
        float(np.abs(want64).max()), 1e-30)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    dev = ops.resolve_device(args.device)
    wl = WORKLOADS[args.workload]
    spec = wl.dataset if args.scale == 1.0 else scaled(wl.dataset,
                                                       args.scale)
    a = synthesize(spec, seed=0)
    inc = InCRS.from_crs(a, wl.section, wl.block)
    card = device_record(dev)
    print(f"workload={wl.name} A={spec.m}x{spec.n} D={spec.density:.3f} "
          f"nnz={a.nnz} device={card['platform']} {card['name']} "
          f"power_limit={card['power_limit']}")

    # A mixed-width trace: narrow and wide requests interleaved.
    bc = args.batch_cols
    widths = [(bc, bc // 2, bc // 4, bc + bc // 2)[r % 4]
              for r in range(args.requests)]

    def trace():
        gen = np.random.default_rng(1)
        return [SpMMRequest(r, gen.normal(size=(spec.n, w)).astype(
            np.float32)) for r, w in enumerate(widths)]

    # Prep once at engine construction, reused by every wave. Warm every
    # path first (each wave bucket's launch, both baselines), so the timed
    # regions compare steady-state execution only.
    cap = max(128, 2 * bc)
    t0 = time.perf_counter()
    eng = SpMMEngine(inc, max_wave_cols=cap, device=dev)
    t_prep = time.perf_counter() - t0
    b_all = torch.from_numpy(np.concatenate([r.b for r in trace()],
                                            axis=1)).to(dev)
    prep = ops.prepare_incrs(inc, device=dev)
    for w in range(WAVE_QUANTUM, -(-cap // WAVE_QUANTUM) * WAVE_QUANTUM + 1,
                   WAVE_QUANTUM):
        ops.spmm(prep, torch.zeros((spec.n, w), device=dev))
    dense_a = torch.from_numpy(a.to_dense().astype(np.float32)).to(dev)

    def twopass():      # densify A through the gather, then the dense GEMM
        return ops.dense_mm(ops.incrs_to_dense(inc, device=dev), b_all,
                            device=dev)

    def dense():
        return ops.dense_mm(dense_a, b_all, device=dev)

    twopass()
    dense()

    # The wave-barrier loop (strict FIFO, no overlap), the baseline of the
    # continuous scheduler.
    barrier = SpMMEngine(inc, max_wave_cols=cap, continuous=False,
                         device=dev)
    for r in trace():
        barrier.submit(r)
    barrier.run()
    sb = barrier.stats_summary()

    t0 = time.perf_counter()
    for r in trace():
        eng.submit(r)
    done = eng.run()
    t_fused = time.perf_counter() - t0
    s = eng.stats_summary()
    print(f"  fused incrs_spmm: prep {t_prep * 1e3:.1f}ms once, "
          f"{len(done)} requests in {t_fused * 1e3:.2f}ms host wall "
          f"({eng.stats['waves']} waves, {eng.stats['cols']} cols)")
    print(f"  continuous: {s['requests_per_s']:.1f} req/s "
          f"p50={s['latency_ms']['p50']:.2f}ms "
          f"p99={s['latency_ms']['p99']:.2f}ms, "
          f"prep overlap {s['prep_overlap_fraction']:.0%}  |  "
          f"wave-barrier: {sb['requests_per_s']:.1f} req/s in "
          f"{sb['waves']} waves (speedup "
          f"{s['requests_per_s'] / max(sb['requests_per_s'], 1e-9):.2f}x)")

    y2, ms_twopass = _timed_ms(twopass, dev)
    yd, ms_dense = _timed_ms(dense, dev)

    # Every request, and both baselines, against the float64 product.
    a64 = a.to_dense().astype(np.float64)
    worst = 0.0
    for r in done + barrier.finished:
        err = _rel_err(r.out, a64 @ r.b.astype(np.float64))
        if not err <= TOL:
            raise RuntimeError(f"request {r.rid}: max|C - C64| = {err} * "
                               f"max|C64| > {TOL}")
        worst = max(worst, err)
    ref = a64 @ b_all.cpu().numpy().astype(np.float64)
    for name, y in (("two-pass", y2), ("dense", yd)):
        err = _rel_err(y.cpu().numpy(), ref)
        if not err <= TOL:
            raise RuntimeError(f"{name} baseline: max|C - C64| = {err} * "
                               f"max|C64| > {TOL}")
    timer = "CUDA events" if dev.type == "cuda" else "host clock, CPU"
    print(f"served {len(done)} requests: fused {t_fused * 1e3:.2f}ms host "
          f"wall; two-pass {ms_twopass:.3f}ms, dense {ms_dense:.3f}ms "
          f"({timer}; {card['name']}, {card['power_limit']}); "
          f"max rel err {worst:.2e} <= {TOL}")
    return {"requests": len(done), "waves": s["waves"],
            "barrier_waves": sb["waves"], "continuous": s, "barrier": sb,
            "fused_s": t_fused, "twopass_ms": ms_twopass,
            "dense_ms": ms_dense, "max_rel_err": worst, "device": card}


if __name__ == "__main__":
    main()
