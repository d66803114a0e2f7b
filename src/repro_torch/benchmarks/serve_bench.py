"""Serving benchmark of the port: the continuous SpMM engine against the
wave-barrier baseline on one mixed-width request trace, and the InCRS
kernel alone at each wave width.

The port of ``benchmarks/serve_bench.py``: the same trace (64 requests of
8–120 columns, 16 with ``--smoke``), the same rows, comparisons and flags,
schema ``bench_serve/v1``. On the card (``--device cuda``, the default) it
serves incrs-docword at its published size (700 × 12,000,
``configs/paper_spmm.py``); on the CPU (``--device cpu``, the kernels'
plain versions) the JAX bench's own 64 × 512 operand. The record names
the device it ran on (``device.platform``, and on a GPU the name and
power limit ``nvidia-smi`` reports):

  {"schema": "bench_serve/v1", "device": {...}, "timer": ...,
   "rows": [{"name": "dense_mm_256", "us": ...},           # machine proxy
            {"name": "incrs_spmm_expand", "us": ...,       # the kernel
             "derived": "cols=128;..."}, ...,              # alone
            {"name": "serve_wave_barrier", "rps": ..., "p50_ms": ...,
             "p99_ms": ..., "waves": ..., "derived": ...}, ...],
   "comparisons": {"continuous_vs_wave_barrier": {...}, ...}}

The ``incrs_spmm_<variant>`` rows time each InCRS kernel order alone at
every 128-column wave bucket up to the continuous cap (CUDA events on the
card, the host clock on the CPU); ``serve.scheduler.seed_from_bench``
seeds a CUDA engine's cost model from them. The two engines' results are
held against each other (1e-4) and against the float64 product (1e-3).

``--check BASELINE`` fails (exit 1) if a serving row's requests/s fell
more than 25 % against the record, after normalizing both sides by their
``dense_mm_256`` row.

Run: PYTHONPATH=src python -m repro_torch.benchmarks.serve_bench \\
         --json BENCH_torch_serve.json
     PYTHONPATH=src python -m repro_torch.benchmarks.serve_bench \\
         --device cpu --smoke
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..configs.paper_spmm import WORKLOADS
from ..core.incrs import InCRS
from ..data import datasets
from ..kernels import incrs_spmm as K
from ..kernels import ops
from ..serve.engine import SpMMEngine, SpMMRequest

# Mixed request widths (cols), weighted toward narrow requests with a
# fat tail: the shape that exposes head-of-line blocking and poor fill in
# a fixed-width FIFO packer.
TRACE_WIDTHS = (8, 16, 16, 24, 32, 48, 72, 96, 120)

# The wave-barrier baseline's fixed wave cap, and the cap the continuous
# engine packs up to.
BARRIER_CAP = 128
CONTINUOUS_CAP = 512

WORKLOAD = "incrs-docword"
VARIANTS = ("expand", "reuse", "pipelined")
KERNELS = {"expand": K.incrs_spmm, "reuse": K.incrs_spmm_reuse,
           "pipelined": K.incrs_spmm_pipelined}
CUDA_REPS = 20           # launches between two CUDA events
HOST_REPS = 3            # host-clock runs, the best kept


def build_trace(rng, k, n_requests):
    widths = rng.choice(TRACE_WIDTHS, size=n_requests)
    return [SpMMRequest(i, rng.normal(size=(k, int(w)))
                        .astype(np.float32))
            for i, w in enumerate(widths)]


def _operand(rng, device: torch.device):
    """(dense A as f32, InCRS A, workload label): incrs-docword at its
    published size on the card, JAX's 64 × 512 operand on the CPU."""
    if device.type == "cuda":
        wl = WORKLOADS[WORKLOAD]
        crs = datasets.synthesize(wl.dataset, seed=0)
        return (crs.to_dense().astype(np.float32),
                InCRS.from_crs(crs, wl.section, wl.block),
                f"{WORKLOAD} {crs.shape[0]}x{crs.shape[1]} "
                f"d={wl.dataset.density}")
    d = rng.normal(size=(64, 512)).astype(np.float32)
    d[rng.random(size=d.shape) >= 0.05] = 0.0
    return d, InCRS.from_dense(d), "64x512 d=0.05"


def _time_us(fn, device: torch.device) -> float:
    """µs of one call of ``fn``: on the card the mean of ``CUDA_REPS``
    launches between two CUDA events after a warm call, on the CPU the
    best of ``HOST_REPS`` host-clock runs."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CUDA_REPS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / CUDA_REPS
    best = float("inf")
    for _ in range(HOST_REPS):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def _serve(make_engine, rng, k, n_requests):
    """Build a fresh engine, serve a fresh trace, return the engine and
    its summary."""
    eng = make_engine()
    for r in build_trace(rng, k, n_requests):
        eng.submit(r)
    done = eng.run()
    if len(done) != n_requests:
        raise RuntimeError(f"served {len(done)} of {n_requests} requests")
    return eng, eng.stats_summary()


def _row(name, s, derived):
    return {"name": name, "rps": round(s["requests_per_s"], 2),
            "p50_ms": round(s["latency_ms"]["p50"], 3),
            "p99_ms": round(s["latency_ms"]["p99"], 3),
            "waves": s["waves"], "cols": s["cols"],
            "prep_overlap_fraction": round(s["prep_overlap_fraction"], 3),
            "derived": derived}


def _kernel_rows(prep, device, workload):
    """Each InCRS kernel order alone at every 128-column bucket up to the
    continuous cap, on a B already padded as ``ops.spmm`` pads it."""
    rows = []
    gen = torch.Generator(device="cpu").manual_seed(0)
    kp = prep.n_sections * prep.section
    for n in range(128, CONTINUOUS_CAP + 1, 128):
        b = torch.randn((kp, n), generator=gen).to(device)
        bn = ops.default_bn(n)
        for v in VARIANTS:
            us = _time_us(lambda: KERNELS[v](prep.idx, prep.val, b,
                                             section=prep.section, bm=128,
                                             bn=bn), device)
            rows.append({"name": f"incrs_spmm_{v}", "us": round(us, 3),
                         "derived": f"cols={n};{workload};kernel alone"})
    return rows


def run(seed: int = 0, smoke: bool = False, device="cuda"):
    device = ops.resolve_device(device)
    rng = np.random.default_rng(seed)
    d, inc, workload = _operand(rng, device)
    k = d.shape[1]
    n_requests = 16 if smoke else 64
    rows, comparisons = [], {}

    # Machine-speed proxy: the port's dense kernel at 256^3, which lets
    # --check compare requests/s across machines.
    a = torch.from_numpy(rng.normal(size=(256, 256)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(256, 256)).astype(np.float32))
    a, b = a.to(device), b.to(device)
    us = _time_us(lambda: ops.dense_mm(a, b, device=device), device)
    rows.append({"name": "dense_mm_256", "us": round(us, 3),
                 "derived": "machine-speed proxy for --check"})

    # Warm every wave bucket up to the cap through the memoized prep, so
    # no engine pays a first launch inside its measured window.
    prep = ops.prepare_incrs(inc, device=device)
    for w in range(128, CONTINUOUS_CAP + 1, 128):
        ops.spmm(prep, torch.zeros((k, w), device=device))
    rows += _kernel_rows(prep, device, workload)

    def engine(cap, **kw):
        return lambda: SpMMEngine(inc, max_wave_cols=cap, device=device,
                                  **kw)

    warm = np.random.default_rng(seed + 1)
    _serve(engine(BARRIER_CAP, continuous=False), warm, k, 4)
    _serve(engine(CONTINUOUS_CAP), warm, k, 8)

    eng_b, barrier = _serve(engine(BARRIER_CAP, continuous=False),
                            np.random.default_rng(seed + 2), k, n_requests)
    rows.append(_row("serve_wave_barrier", barrier,
                     f"cap={BARRIER_CAP};fixed-width FIFO, no overlap"))
    eng_c, cont = _serve(engine(CONTINUOUS_CAP),
                         np.random.default_rng(seed + 2), k, n_requests)
    rows.append(_row("serve_continuous", cont,
                     f"cap<={CONTINUOUS_CAP};cost-model width, skip-scan, "
                     f"prep overlap"))

    # The same trace through both engines: the same math.
    d64 = d.astype(np.float64)
    for rb, rc in zip(sorted(eng_b.finished, key=lambda r: r.rid),
                      sorted(eng_c.finished, key=lambda r: r.rid)):
        np.testing.assert_allclose(rb.out, rc.out, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(rb.out, d64 @ rb.b.astype(np.float64),
                                   rtol=1e-3, atol=1e-3)

    comparisons["continuous_vs_wave_barrier"] = {
        "continuous_rps": cont["requests_per_s"],
        "barrier_rps": barrier["requests_per_s"],
        "speedup": cont["requests_per_s"]
        / max(barrier["requests_per_s"], 1e-9),
        "continuous_waves": cont["waves"],
        "barrier_waves": barrier["waves"],
        "prep_overlap_fraction": cont["prep_overlap_fraction"],
        "prep_s_total": round(cont["prep_s_total"], 5),
        "prep_s_hidden": round(cont["prep_s_hidden"], 5),
        "cost_model_source": cont["cost_model"]["source"],
        "workload": f"{workload}, {n_requests} mixed-width requests "
                    f"{min(TRACE_WIDTHS)}-{max(TRACE_WIDTHS)} cols; "
                    f"barrier@{BARRIER_CAP} fixed vs cost-model"
                    f"<={CONTINUOUS_CAP}",
        "crosscheck": "engines within 1e-4, float64 within 1e-3",
    }

    if not smoke:
        # The skip-scan packing alone, at the barrier's own cap.
        _, samecap = _serve(engine(BARRIER_CAP),
                            np.random.default_rng(seed + 2), k, n_requests)
        rows.append(_row("serve_continuous_samecap", samecap,
                         f"cap={BARRIER_CAP};skip-scan + overlap only"))
        comparisons["samecap_vs_wave_barrier"] = {
            "samecap_rps": samecap["requests_per_s"],
            "barrier_rps": barrier["requests_per_s"],
            "speedup": samecap["requests_per_s"]
            / max(barrier["requests_per_s"], 1e-9),
            "workload": f"same trace, both at cap {BARRIER_CAP}",
        }
        # Latency-budget mode: the cost model narrows waves to a budget.
        _, budget = _serve(engine(CONTINUOUS_CAP, latency_budget_us=2500.0),
                           np.random.default_rng(seed + 2), k, n_requests)
        rows.append(_row("serve_continuous_budget2500us", budget,
                         f"cap<={CONTINUOUS_CAP};latency_budget_us=2500"))
    return rows, comparisons


def device_record(device: torch.device) -> dict:
    """The device a record was taken on: ``platform`` ("gpu" or "cpu")
    and, on a GPU, the name and power limit ``nvidia-smi`` reports."""
    if device.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "power_limit": None}
    rec = {"platform": "gpu", "name": torch.cuda.get_device_name(device),
           "power_limit": "not read"}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index}"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return rec
    name, limit = out.strip().splitlines()[0].rsplit(",", 1)
    return {**rec, "name": name.strip(), "power_limit": limit.strip()}


# Regression gate: requests/s rows regress downward, normalized on both
# sides by their dense_mm_256 machine proxy.
CHECK_TOLERANCE = 0.25
_NORM_ROW = "dense_mm_256"


def check_regressions(rows, baseline_path, tolerance=CHECK_TOLERANCE):
    """A list of failure strings (empty = pass)."""
    try:
        with open(baseline_path) as f:
            base = json.load(f)
    except (OSError, ValueError) as e:
        return [f"cannot read baseline {baseline_path}: {e}"]
    base_rows = {r["name"]: r for r in base.get("rows", [])}
    new_rows = {r["name"]: r for r in rows}
    norm_old = base_rows.get(_NORM_ROW, {}).get("us")
    norm_new = new_rows.get(_NORM_ROW, {}).get("us")
    if not norm_old or not norm_new:
        return [f"norm row {_NORM_ROW!r} missing from baseline or run"]
    failures = []
    for name, row in new_rows.items():
        rps = row.get("rps")
        old = base_rows.get(name, {}).get("rps")
        if rps is None or old is None:
            continue                    # new row / non-throughput row
        rel = (rps * norm_new) / (old * norm_old)
        if rel < 1.0 - tolerance:
            failures.append(
                f"{name}: {rps:.1f} req/s vs baseline {old:.1f} req/s "
                f"(machine-relative {rel:.2f}x < "
                f"{1 - tolerance:.2f}x allowed)")
    return failures


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None,
                    help="write machine-readable results to this path")
    ap.add_argument("--check", default=None, metavar="BASELINE",
                    help="fail (exit 1) if a serving row's requests/s "
                         "regresses >25%% vs this record (machine-relative)")
    ap.add_argument("--smoke", action="store_true", help="small trace")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = ops.resolve_device(args.device)
    rows, comparisons = run(seed=args.seed, smoke=args.smoke, device=device)
    for row in rows:
        if "rps" in row:
            print(f"serve,{row['name']},{row['rps']:.1f}req/s,"
                  f"p50={row['p50_ms']:.2f}ms,p99={row['p99_ms']:.2f}ms,"
                  f"waves={row['waves']},{row['derived']}")
        else:
            print(f"serve,{row['name']},{row['us']:.1f}us,{row['derived']}")
    for name, c in comparisons.items():
        print(f"compare,{name},speedup={c['speedup']:.2f}x")
    print(f"crosscheck,ok,"
          f"{comparisons['continuous_vs_wave_barrier']['crosscheck']}")
    record = {
        "schema": "bench_serve/v1",
        "backend": "torch",
        "device": device_record(device),
        "timer": "cuda_events" if device.type == "cuda" else "host_clock",
        "rows": rows,
        "comparisons": comparisons,
    }
    dev = record["device"]
    print(f"device,{dev['platform']},{dev['name']},{dev['power_limit']}")
    failures = []
    if args.check:
        failures = check_regressions(rows, args.check)
        for f in failures:
            print(f"regression,{f}", file=sys.stderr)
        if not failures:
            print(f"check,ok,vs={args.check}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=2)
        print(f"wrote {args.json}")
    if failures:
        sys.exit(1)
    return record


if __name__ == "__main__":
    main()
