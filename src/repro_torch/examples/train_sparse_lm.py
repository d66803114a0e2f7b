"""End-to-end LM training: a small LM with BLOCK-SPARSE FFNs (the paper's
block sparsity as a training-time feature) against its dense twin.

The port of ``examples/train_sparse_lm.py``, on the card unless
``--device cpu``. The sparse twin's FFN computes x @ (W ⊙ block mask),
the JAX layer's mask-dense form (``models/layers.py`` ``_maybe_sparse_mm``):
the masks are fixed buffers that take no gradient step. As in the JAX
example they stay at their init, all ones.

Defaults are CPU-sized; pass --d-model 768 --layers 12 --steps 300 for
the ~100M-parameter configuration.

Run: PYTHONPATH=src python -m repro_torch.examples.train_sparse_lm --steps 30
     PYTHONPATH=src python -m repro_torch.examples.train_sparse_lm --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

from ..data.pipeline import Prefetcher, SyntheticTokens
from ..kernels.ops import resolve_device
from ..models.config import BlockSparsity, ModelConfig
from ..train import trainer
from ..train.optimizer import AdamWConfig


def build(name, d_model, layers, vocab, sparse, block) -> ModelConfig:
    return ModelConfig(
        name, layers, d_model, max(2, d_model // 64), max(1, d_model // 128),
        4 * d_model, vocab, dtype="float32",
        sparsity=BlockSparsity(block=block, density=0.5) if sparse else None)


def run(cfg: ModelConfig, steps: int, batch: int, seq: int, *, seed: int = 0,
        device=None) -> Dict[str, float]:
    opt = AdamWConfig(lr=1e-3, warmup_steps=max(2, steps // 10),
                      total_steps=steps)
    model, opt_state = trainer.init_train_state(cfg, opt, seed=seed,
                                                device=device)
    n = sum(p.numel() for p in model.parameters())
    step = trainer.build_train_step(cfg, opt, n_micro=1)
    data = Prefetcher(SyntheticTokens(cfg.vocab_size, batch, seq, seed=1),
                      timeout_s=30.0)
    t0, first, last = time.time(), None, None
    for _ in range(steps):
        model, opt_state, m = step(model, opt_state, next(data))
        if first is None:
            first = float(m["loss"])
        last = float(m["loss"])
    data.close()
    dt = time.time() - t0
    print(f"  {cfg.name}: {n/1e6:.1f}M params, loss {first:.3f} -> "
          f"{last:.3f} in {steps} steps ({batch*seq*steps/dt:,.0f} tok/s)")
    return {"first": first, "last": last}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--block", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"dense FFN vs block-sparse FFN (BlockSparsity density 0.5, "
          f"mask-dense, masks at their init) on {device}:")
    dense = run(build("dense-lm", args.d_model, args.layers, args.vocab,
                      False, args.block), args.steps, args.batch, args.seq,
                device=device)
    sparse = run(build("sparse-lm", args.d_model, args.layers, args.vocab,
                       True, args.block), args.steps, args.batch, args.seq,
                 device=device)
    print(f"  final losses: dense {dense['last']:.3f}, sparse "
          f"{sparse['last']:.3f}")
    return {"dense": dense, "sparse": sparse}


if __name__ == "__main__":
    main()
