"""Training launcher: config -> model -> data -> train loop -> checkpoints.

The port of ``repro.launch.train`` on one device (the card unless
``--device cpu``), with every flag of the JAX launcher and the same log
line; ``--losses-out`` also writes every step's loss, exactly, as JSON.

  python -m repro_torch.launch.train --arch granite-34b --smoke --steps 50
  python -m repro_torch.launch.train --arch granite-34b --smoke --resume \\
      --ckpt-dir /tmp/ck --device cpu

Every architecture of the port's registry trains: the dense ones, the
MoE ones (mixtral-8x7b, qwen2-moe-a2.7b), the embeds ones
(musicgen-medium, internvl2-1b, whose batches carry ``prefix_embeds``)
and the recurrent ones (mamba2-370m's SSD, recurrentgemma-2b's RG-LRU).
"""
from __future__ import annotations

import argparse
import json
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-34b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--int8-opt", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prune-final-density", type=float, default=None,
                    help="magnitude-re-prune every sparse-linear layer on "
                         "the cubic schedule down to this density (no-op "
                         "for configs without sparse layers)")
    ap.add_argument("--prune-nm", default=None, metavar="N:M",
                    help="structured N:M re-pruning (e.g. 2:4): exactly N "
                         "survivors per M-group along d_in; the schedule "
                         "gates WHEN, the density is fixed at N/M "
                         "(mutually exclusive with --prune-final-density)")
    ap.add_argument("--prune-every", type=int, default=10,
                    help="re-prune cadence in steps")
    ap.add_argument("--prune-warmup-frac", type=float, default=0.1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    ap.add_argument("--losses-out", default=None, metavar="PATH",
                    help="write {step: loss} of every step run, as JSON")
    return ap.parse_args(argv)


def _prune_callback(args, trainer):
    """The prune callback the flags ask for, or None; flag conflicts exit
    with the JAX launcher's messages."""
    if args.prune_final_density is not None and args.prune_nm is not None:
        raise SystemExit("flag conflict: pass --prune-final-density OR "
                         "--prune-nm, not both — an N:M policy fixes the "
                         "final density at N/M")
    if args.prune_final_density is None and args.prune_nm is None:
        return None
    prune_flag = ("--prune-nm" if args.prune_nm is not None
                  else "--prune-final-density")
    if args.int8_opt:
        # fail NOW, not at the first due step after the dense warmup:
        # quantized moments cannot ride a slot remap.
        raise SystemExit(
            f"flag conflict: {prune_flag} cannot be combined with "
            f"--int8-opt. A pattern repack remaps value slots, and "
            f"int8-quantized AdamW moments cannot follow (their "
            f"per-block quantization scales do not survive the "
            f"remap). Drop --int8-opt so the optimizer runs with "
            f"plain f32 moments (AdamWConfig(quantize=False)) — the "
            f"sparsity lifecycle requires it.")
    from ..sparse.pattern import PruneSchedule, parse_nm
    if args.prune_nm is not None:
        n, m = parse_nm(args.prune_nm)
        final_density, policy = n / m, args.prune_nm
    else:
        final_density, policy = args.prune_final_density, "magnitude"
    return trainer.make_prune_callback(PruneSchedule(
        final_density, args.steps, warmup_frac=args.prune_warmup_frac,
        every=args.prune_every), policy=policy)


def main(argv=None):
    args = parse_args(argv)

    from .. import configs
    from ..checkpoint import CheckpointManager
    from ..data.pipeline import Prefetcher, SyntheticTokens
    from ..kernels.ops import resolve_device
    from ..train import trainer
    from ..train.optimizer import AdamWConfig

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    prune_cb = _prune_callback(args, trainer)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                          total_steps=args.steps, quantize=args.int8_opt)
    device = resolve_device(args.device)

    model, opt_state = trainer.init_train_state(cfg, opt_cfg, seed=args.seed,
                                                device=device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M device={device}")

    step_fn = trainer.build_train_step(cfg, opt_cfg, n_micro=args.n_micro)

    ck = None
    start_step = 0
    if args.ckpt_dir:
        ck = CheckpointManager(args.ckpt_dir, keep=3)
        if args.resume and ck.latest_step() is not None:
            start_step = ck.latest_step()
            state = ck.restore(start_step, {"params": model,
                                            "opt": opt_state})
            opt_state = state["opt"]
            print(f"resumed from step {start_step}")

    src = SyntheticTokens(cfg.vocab_size, args.batch, args.seq,
                          seed=args.seed,
                          n_prefix=(cfg.n_prefix_embeds
                                    if cfg.input_mode == "embeds" else 0),
                          d_model=cfg.d_model)
    src.step = start_step
    data = Prefetcher(src, depth=2, timeout_s=60.0,
                      fallback=lambda n: src.batch_at(10**9 + n))

    t0 = time.time()
    tokens_done = 0
    metrics = None
    losses = {}
    for step in range(start_step, args.steps):
        if prune_cb is not None:
            pinfo = prune_cb(step, model, opt_state)
            if pinfo:
                print(f"step {step:5d}  re-pruned {pinfo['layers']} layers "
                      f"to density {pinfo['density']:.3f} "
                      f"({pinfo['nnz']} non-zeros)", flush=True)
        model, opt_state, metrics = step_fn(model, opt_state, next(data))
        losses[step + 1] = float(metrics["loss"])
        tokens_done += args.batch * args.seq
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            dt = time.time() - t0
            print(f"step {step+1:5d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"tok/s {tokens_done/dt:,.0f}", flush=True)
        if ck and (step + 1) % args.ckpt_every == 0:
            ck.save(step + 1, {"params": model, "opt": opt_state})
    if ck:
        ck.save(args.steps, {"params": model, "opt": opt_state})
        ck.wait()
    data.close()
    if args.losses_out:
        with open(args.losses_out, "w") as f:
            json.dump(losses, f)
    return float(metrics["loss"]) if metrics is not None else None


if __name__ == "__main__":
    main()
