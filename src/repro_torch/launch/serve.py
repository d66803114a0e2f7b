"""Serving launcher: an LM through ``ServeEngine``, or the paper's SpMM
workload through ``SpMMEngine``, on CUDA unless ``--device cpu``.

LM mode serves ``--n-requests`` random prompts of ``--prompt-len`` tokens
on ``--arch`` (``--smoke`` for its small config) with weights drawn from
``--seed``; prompts of 8,192 tokens or more prefill through the flash
kernel. It prints the tokens served and the kernel launches:

  python -m repro_torch.launch.serve --arch granite-34b --smoke \
      --prompt-len 8192 --n-requests 2 --max-new 4

SpMM mode (``--spmm``) serves one fixed sparse operand and a queue of
dense right-hand sides. ``--format incrs`` serves the InCRS operand on the
fused InCRS kernels; ``--format bsr`` (tiles of side ``--spmm-block``) and
``--format dense`` serve it through the plan–execute API,
``sparse.plan_for_operand``:

  python -m repro_torch.launch.serve --spmm --workload incrs-docword \
      --scale 1.0
  python -m repro_torch.launch.serve --spmm --workload incrs-docword \
      --format bsr --spmm-block 50 --spmm-swap

``--spmm-shards N`` row-shards the InCRS operand across a mesh of N
shards (``launch.mesh.make_mesh``): the first N visible cards with
``--device cuda`` (fewer raise, naming the count), one card N times with
``--device cuda:0``, N logical CPU shards with ``--device cpu``:

  python -m repro_torch.launch.serve --spmm --spmm-shards 4 --device cpu

Without ``--workload`` the operand is a synthetic ``--spmm-rows`` x
``--spmm-cols`` matrix of ``--spmm-density``. ``--spmm-swap`` re-prunes the
operand to half its density by magnitude and swaps it into the running
engine, then serves a second batch. Every result is checked against the
dense float64 product on the host; a wrong one fails the run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _operand(fmt: str, crs, dense: np.ndarray, section: int, block: int,
             spmm_block: int, device, mask=None):
    """The served operand in ``fmt`` — InCRS from the CRS ``crs``, a plan
    from its ``dense`` form — and the host seconds its plan took (None for
    InCRS, prepped by the engine)."""
    from ..core.incrs import InCRS
    from ..sparse import api
    if fmt == "incrs":
        return InCRS.from_crs(crs, section, block), None
    t0 = time.perf_counter()
    spec = api.SparseSpec(fmt, block=spmm_block if fmt == "bsr" else None,
                          mask=None if mask is None
                          else np.ascontiguousarray(mask.T))
    bound = api.plan_for_operand(dense, spec, device=device)
    return bound, time.perf_counter() - t0


def _serve(eng, reqs, ref: np.ndarray) -> float:
    """Serve ``reqs`` to the end; the worst error against the float64
    product, relative to max|C|."""
    for r in reqs:
        eng.submit(r)
    mine = {id(r) for r in reqs}
    done = [r for r in eng.run() if id(r) in mine]
    worst = 0.0
    for r in done:
        want = ref @ r.b.astype(np.float64)
        err = float(np.abs(r.out - want).max())
        worst = max(worst, err / max(float(np.abs(want).max()), 1e-30))
    return worst if len(done) == len(reqs) else float("inf")


def _main_spmm(args) -> int:
    from ..configs.paper_spmm import WORKLOADS
    from ..core.crs import CRS
    from ..data.datasets import DatasetSpec, scaled, synthesize
    from ..serve.engine import SpMMEngine, SpMMRequest
    from ..sparse.pattern import magnitude_mask

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
    dense = a.to_dense()
    mesh = None
    if args.spmm_shards > 1:
        from .mesh import make_mesh
        if args.format != "incrs":
            raise SystemExit(f"--spmm-shards is the row-sharded InCRS "
                             f"data path; --format {args.format} does "
                             f"not shard")
        try:
            mesh = make_mesh(args.spmm_shards, args.device)
        except ValueError as e:
            raise SystemExit(f"--spmm-shards {args.spmm_shards}: {e}")
    operand, plan_s = _operand(args.format, a, dense, section, block,
                               args.spmm_block, args.device)
    eng = SpMMEngine(operand, max_wave_cols=args.spmm_max_wave_cols,
                     device=None if mesh is not None else args.device,
                     mesh=mesh, continuous=not args.spmm_wave_barrier,
                     latency_budget_us=args.spmm_latency_budget_us)
    rng = np.random.default_rng(args.seed)
    reqs = [SpMMRequest(i, rng.normal(
        size=(spec.n, args.spmm_batch_cols)).astype(np.float32))
        for i in range(args.n_requests)]
    t0 = time.time()
    worst = _serve(eng, reqs, dense.astype(np.float64))
    dt = time.time() - t0
    s = eng.stats_summary()
    block_txt = f" block={args.spmm_block}" if args.format == "bsr" else ""
    where = f"single-device {eng.device}" if mesh is None else (
        f"{args.spmm_shards}-way row-sharded over "
        f"{sorted({str(d) for d in mesh.device_list})}, "
        f"{eng.prep.rows_per_shard} rows a shard")
    print(f"spmm A={spec.m}x{spec.n} d={spec.density} nnz={a.nnz} "
          f"format={args.format}{block_txt} ({where}, "
          f"{s['mode']}): served {s['requests']} requests / "
          f"{eng.stats['cols']} cols in {dt:.2f}s, "
          f"waves={eng.stats['waves']}")
    if plan_s is not None:
        print(f"  plan_for_operand on the host: {plan_s * 1e3:.3f} ms")
    print(f"  {s['requests_per_s']:.3f} req/s, latency "
          f"p50={s['latency_ms']['p50']:.3f}ms "
          f"p99={s['latency_ms']['p99']:.3f}ms, prep overlap "
          f"{s['prep_overlap_fraction']:.0%}")
    print(f"  max |err| / max|C| vs dense float64 oracle: {worst:.2e}")
    if args.spmm_swap and worst <= 1e-4:
        # Live pattern swap = plan rebuild: magnitude-re-prune the operand
        # to half its density under the SAME format and deploy it into the
        # RUNNING engine between waves.
        mask_a = magnitude_mask(dense, spec.density / 2)
        pruned = np.where(mask_a, dense, 0.0).astype(np.float32)
        crs2 = CRS.from_dense(pruned) if args.format == "incrs" else None
        swapped, _ = _operand(args.format, crs2, pruned, section, block,
                              args.spmm_block, eng.device, mask=mask_a)
        eng.swap_pattern(swapped, mesh=mesh)
        reqs2 = [SpMMRequest(100 + i, rng.normal(
            size=(spec.n, args.spmm_batch_cols)).astype(np.float32))
            for i in range(args.n_requests)]
        worst2 = _serve(eng, reqs2, pruned.astype(np.float64))
        print(f"  swapped to d={mask_a.mean():.3f} "
              f"(swaps={eng.stats['pattern_swaps']}): served "
              f"{len(reqs2)} more, max |err| / max|C|: {worst2:.2e}")
        worst = max(worst, worst2)
    from ..kernels import bsr_spmm, dense_mm, incrs_spmm
    launches = {**incrs_spmm.LAUNCHES, **bsr_spmm.LAUNCHES,
                **dense_mm.LAUNCHES}
    print(f"  waves total {eng.stats['waves']}, kernel launches "
          f"{json.dumps(launches)}")
    if worst > 1e-4:
        print("  FAILED: a result is missing or off by more than "
              "1e-4 * max|C|", file=sys.stderr)
        return 1
    return 0


def _main_lm(args) -> int:
    from .. import configs
    from ..kernels import flash_attention
    from ..models import layers
    from ..models import model as M
    from ..serve.engine import Request, ServeEngine

    cfg = configs.get_smoke(args.arch) if args.smoke else \
        configs.get(args.arch)
    model = M.init(cfg, seed=args.seed, device=args.device)
    eng = ServeEngine(model, n_slots=args.n_slots,
                      cache_dtype=layers.torch_dtype(cfg.dtype),
                      seed=args.seed)
    rng = np.random.default_rng(args.seed)
    for i in range(args.n_requests):
        eng.submit(Request(
            i, rng.integers(0, cfg.vocab_size,
                            args.prompt_len).astype(np.int32),
            max_new=args.max_new, temperature=args.temperature))
    t0 = time.time()
    done = eng.run()
    dt = time.time() - t0
    total_new = sum(len(r.out) for r in done)
    print(f"arch={cfg.name} served {len(done)} requests, "
          f"{total_new} tokens in {dt:.1f}s "
          f"({total_new/dt:.1f} tok/s), waves={eng.stats['waves']}")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.out[:8]}...")
    print(f"  device {model.device}, kernel launches "
          f"{json.dumps(flash_attention.LAUNCHES)}")
    return 0


def main(argv=None) -> int:
    from ..configs import ARCH_NAMES, UNPORTED
    from ..configs.paper_spmm import WORKLOADS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-34b",
                    choices=ARCH_NAMES + tuple(UNPORTED),
                    help="LM to serve (the names not yet ported raise, "
                         "naming their ROADMAP item)")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's small config")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--spmm", action="store_true",
                    help="serve the paper's SpMM workload instead of an LM")
    ap.add_argument("--format", default="incrs",
                    choices=("incrs", "bsr", "dense"),
                    help="kernel family of the served operand")
    ap.add_argument("--spmm-block", type=int, default=64,
                    help="tile side of --format bsr; must divide both "
                         "dimensions of the operand")
    ap.add_argument("--spmm-shards", type=int, default=1,
                    help="row-shard the InCRS operand across this many "
                         "shards (1 = single-device); see --device")
    ap.add_argument("--spmm-swap", action="store_true",
                    help="after the first batch, swap in the operand "
                         "re-pruned to half its density and serve again")
    ap.add_argument("--workload", default=None, choices=sorted(WORKLOADS),
                    help="a Table II / IV dataset (default: the synthetic "
                         "--spmm-rows x --spmm-cols operand)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="shrink --workload's rows and columns by this")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, cuda:<i> or cpu)")
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
    return _main_spmm(args) if args.spmm else _main_lm(args)


if __name__ == "__main__":
    sys.exit(main())
