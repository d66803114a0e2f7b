"""End-to-end sparsity LIFECYCLE on the fused InCRS kernel:

  schedule -> repack -> checkpoint -> resume -> hot-swap deploy.

The port of ``examples/train_reprune.py``. A 2-layer MLP student starts
DENSE (every slot of an all-True ``SparsityPattern`` is trainable),
regresses a dense teacher on the fused InCRS forward and backward, and is
magnitude-re-pruned down the cubic ``PruneSchedule`` by the prune
callback (``train.trainer.make_prune_callback``): values surviving each
pattern change carry over, and the AdamW moments ride the same repack.
Every step is checkpointed through ``checkpoint.CheckpointManager``
(patterns ride along); halfway, the run is resumed into a FRESH dense
model, which the restore repacks to the saved pattern, so training goes
on mid-schedule with the exact pruned shapes. A ``serve.SpMMEngine``
starts serving the layer's INITIAL pattern; after training, the final
re-pruned pattern is hot-swapped into the RUNNING engine with
``swap_pattern`` (no restart) and the served results are checked against
the trained dense weight.

Run: PYTHONPATH=src python -m repro_torch.examples.train_reprune --steps 24
     PYTHONPATH=src python -m repro_torch.examples.train_reprune \\
         --device cpu
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..serve.engine import SpMMEngine, SpMMRequest
from ..sparse import Linear, SparseSpec
from ..sparse.pattern import PruneSchedule
from ..train.optimizer import AdamWConfig, adamw_init
from ..train.trainer import make_prune_callback
from .train_unstructured import train_step

SERVE_TOL = 1e-3     # the JAX example's rtol = atol on the served results


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d-in", type=int, default=128)
    ap.add_argument("--d-hidden", type=int, default=128)
    ap.add_argument("--d-out", type=int, default=64)
    ap.add_argument("--density", type=float, default=0.15,
                    help="final target density of the schedule")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--prune-every", type=int, default=2)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--section", type=int, default=64)
    ap.add_argument("--block", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temp dir)")
    return ap.parse_args(argv)


def build_student(args, spec: SparseSpec, device) -> torch.nn.ModuleDict:
    """The dense 2-layer student, weights from fixed seeds."""
    return torch.nn.ModuleDict({
        "l1": Linear.init(args.d_in, args.d_hidden, spec, scale=0.2,
                          generator=torch.Generator().manual_seed(1),
                          device=device),
        "l2": Linear.init(args.d_hidden, args.d_out, spec, scale=0.2,
                          generator=torch.Generator().manual_seed(2),
                          device=device)})


def main(argv=None) -> Dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    rng = np.random.default_rng(0)
    w1 = rng.normal(size=(args.d_in, args.d_hidden)).astype(np.float32) * 0.2
    w2 = rng.normal(size=(args.d_hidden, args.d_out)).astype(np.float32) * 0.2
    x = torch.from_numpy(rng.normal(size=(args.batch, args.d_in))
                         .astype(np.float32)).to(device)
    y = torch.tanh(x @ torch.from_numpy(w1).to(device)) @ \
        torch.from_numpy(w2).to(device)

    # density=1.0 -> an all-live pattern: the layers START dense and the
    # schedule prunes them down.
    spec = SparseSpec("incrs", density=1.0, section=args.section,
                      block=args.block)
    model = build_student(args, spec, device)
    print(f"student starts dense: l1 density {model['l1'].density:.2f}, "
          f"target {args.density}")

    opt = AdamWConfig(lr=3e-3, weight_decay=0.0,
                      warmup_steps=max(2, args.steps // 10),
                      total_steps=args.steps)
    state = adamw_init(opt, dict(model.named_parameters()))
    schedule = PruneSchedule(args.density, args.steps, warmup_frac=0.2,
                             every=args.prune_every)
    prune_cb = make_prune_callback(schedule)

    # Serving starts on the INITIAL (dense) pattern; the engine keeps
    # running across the whole training run and gets the final pattern
    # hot-swapped in at the end.
    eng = SpMMEngine(model["l1"], max_wave_cols=256)
    eng.submit(SpMMRequest(0, rng.normal(size=(args.d_in, 16))
                           .astype(np.float32)))
    eng.run()

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="reprune_ck_")
    ck = CheckpointManager(ckpt_dir, keep=2, async_write=False)
    resume_at = args.steps // 2
    losses, repacks = [], 0

    def run_steps(model, state, lo, hi):
        nonlocal repacks
        for step in range(lo, hi):
            info = prune_cb(step, model, state)
            if info:
                repacks += 1
                print(f"  step {step:3d}: re-pruned {info['layers']} layers "
                      f"to density {info['density']:.3f} (pattern "
                      f"v{model['l1'].pattern.version})")
            loss, state, _ = train_step(opt, model, state, x, y)
            losses.append(float(loss))
            ck.save(step + 1, {"params": model, "opt": state})
        return state

    t0 = time.perf_counter()
    state = run_steps(model, state, 0, resume_at)
    mid_version = model["l1"].pattern.version
    if mid_version == 0:
        raise RuntimeError("the schedule should have re-pruned by mid-run")

    # simulated preemption: a fresh DENSE model, restored and continued
    print(f"resuming at step {ck.latest_step()} from {ckpt_dir} (pattern "
          f"v{mid_version}, mid-schedule)")
    model = build_student(args, spec, device)
    template = {"params": model,
                "opt": adamw_init(opt, dict(model.named_parameters()))}
    state = ck.restore(ck.latest_step(), template)["opt"]
    if model["l1"].pattern.version != mid_version:
        raise RuntimeError(f"restore landed at pattern "
                           f"v{model['l1'].pattern.version}, not the saved "
                           f"v{mid_version}")
    state = run_steps(model, state, resume_at, args.steps)
    # final schedule tick: the cubic curve reaches final_density exactly
    # AT total_steps.
    info = prune_cb(args.steps, model, state)
    if info:
        repacks += 1
        print(f"  final re-prune to density {info['density']:.3f} "
              f"(pattern v{model['l1'].pattern.version})")
    train_s = time.perf_counter() - t0
    dens = model["l1"].density
    version = model["l1"].pattern.version
    print(f"trained {args.steps} steps in {train_s:.1f}s: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, l1 density {dens:.3f} "
          f"(pattern v{version})")
    if version == 0:
        raise RuntimeError("the schedule should have re-pruned the layer")
    tol = 1.5 / (args.d_in * args.d_hidden)
    if not dens <= args.density + max(0.02, tol):
        raise RuntimeError(f"l1 density {dens:.3f} did not reach the "
                           f"target {args.density}")

    # Hot-swap the final pattern into the running engine.
    eng.swap_pattern(model["l1"])
    if eng.pattern_version != version:
        raise RuntimeError(f"engine records pattern v{eng.pattern_version},"
                           f" the layer is v{version}")
    reqs = [SpMMRequest(i + 1, rng.normal(size=(args.d_in, 16))
                        .astype(np.float32)) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    done = [r for r in eng.run() if r.rid > 0]
    if len(done) != len(reqs):
        raise RuntimeError(f"served {len(done)} of {len(reqs)} requests")
    w1_trained = model["l1"].to_dense()
    worst = 0.0
    for r in done:
        want = w1_trained.T.astype(np.float64) @ r.b.astype(np.float64)
        err = np.abs(r.out - want)
        if not np.all(err <= SERVE_TOL + SERVE_TOL * np.abs(want)):
            raise RuntimeError(f"request {r.rid}: served result off the "
                               f"trained weight by {float(err.max()):.3e}")
        worst = max(worst, float(err.max()))
    print(f"hot-swapped pattern v{eng.pattern_version} into the running "
          f"engine (swaps={eng.stats['pattern_swaps']}); served "
          f"{len(done)} requests on the final pattern (max |err| "
          f"{worst:.1e}) — schedule -> repack -> checkpoint -> resume -> "
          f"deploy OK")
    if args.ckpt_dir is None:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"losses": losses, "density": dens, "version": version,
            "mid_version": mid_version, "repacks": repacks,
            "swaps": eng.stats["pattern_swaps"], "served_err": worst,
            "train_s": train_s}


if __name__ == "__main__":
    main()
