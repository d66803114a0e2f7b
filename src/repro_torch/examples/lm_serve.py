"""Serve a small LM with batched requests through the wave engine: the
decode_32k / long_500k dry-run cells at toy scale, on the card.

The port of ``examples/lm_serve.py``: the architecture's smoke config,
weights from a seed, requests of random tokens through ``ServeEngine``.

Run: PYTHONPATH=src python -m repro_torch.examples.lm_serve \\
         [--arch recurrentgemma-2b] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .. import configs
from ..models import layers
from ..models import model as M
from ..serve.engine import Request, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b",
                    choices=configs.ARCH_NAMES)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:<i> or cpu)")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch)
    model = M.init(cfg, seed=0, device=args.device)
    eng = ServeEngine(model, n_slots=4,
                      cache_dtype=layers.torch_dtype(cfg.dtype))
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(i, rng.integers(
            0, cfg.vocab_size, args.prompt_len).astype(np.int32),
            max_new=args.max_new, temperature=args.temperature))
    t0 = time.time()
    done = eng.run()
    dt = time.time() - t0
    n_tok = sum(len(r.out) for r in done)
    print(f"{cfg.name} on {model.device}: {len(done)} requests, {n_tok} new "
          f"tokens, {dt:.1f}s ({n_tok/dt:.1f} tok/s), "
          f"waves={eng.stats['waves']}")
    for r in done[:2]:
        print(f"  req {r.rid} -> {r.out}")
    if len(done) != args.requests or n_tok != args.requests * args.max_new:
        raise RuntimeError(f"served {len(done)} of {args.requests} requests "
                           f"and {n_tok} tokens")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
