"""End-to-end SPARSE training behind one spec: ``sparse.Linear``.

The port of ``examples/train_unstructured.py``. A 2-layer MLP student
with sparse weights regresses a dense teacher. The kernel family is a
``--format`` flag, not a code path: ``incrs`` trains element-level
sparsity on the fused InCRS kernel (forward, and dx over the transposed
stripes; dW gathered over the stripe ``idx``, T multiply-adds per stored
non-zero), ``bsr`` trains whole tiles on the BSR kernel (forward, and dx
over the transposed block lists; dW per real block). The weights are the
layers' ``values`` Parameters, updated by AdamW either way; nothing at the
call site changes but the ``SparseSpec``.

After training, the first layer is served unchanged by
``serve.SpMMEngine``, which takes the ``sparse.Linear`` itself.

Run: PYTHONPATH=src python -m repro_torch.examples.train_unstructured
     PYTHONPATH=src python -m repro_torch.examples.train_unstructured \\
         --format bsr --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..serve.engine import SpMMEngine, SpMMRequest
from ..sparse import Linear, SparseSpec, apply
from ..train.optimizer import AdamWConfig, adamw_init, adamw_update

GRAD_TOL = 1e-4      # max|grad - dense oracle| <= GRAD_TOL * max|oracle|
SERVE_TOL = 1e-4     # max|served - float64| <= SERVE_TOL * max|C|


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--format", default="incrs", choices=("incrs", "bsr"),
                    help="kernel family — a SparseSpec field, same "
                         "training loop either way")
    ap.add_argument("--d-in", type=int, default=128)
    ap.add_argument("--d-hidden", type=int, default=256)
    ap.add_argument("--d-out", type=int, default=64)
    ap.add_argument("--density", type=float, default=0.1)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--section", type=int, default=64)
    ap.add_argument("--block", type=int, default=8,
                    help="InCRS counter block (incrs) / tile side (bsr "
                         "uses --bsr-block)")
    ap.add_argument("--bsr-block", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap.parse_args(argv)


def student_spec(fmt: str, density: float, *, section: int, block: int,
                 bsr_block: int) -> SparseSpec:
    if fmt == "incrs":
        return SparseSpec("incrs", density=density, section=section,
                          block=block)
    return SparseSpec("bsr", density=density, block=bsr_block)


def mlp_loss(model: Mapping[str, Linear], x: torch.Tensor,
             y: torch.Tensor, *, hidden: Dict | None = None
             ) -> torch.Tensor:
    """mean((tanh(x @ W1) @ W2 - y)^2); ``hidden`` (a dict), when given,
    gets the hidden activations under ``"h"`` with their gradient kept."""
    h = torch.tanh(apply(model["l1"], x))
    if hidden is not None:
        h.retain_grad()
        hidden["h"] = h
    return torch.mean((apply(model["l2"], h) - y) ** 2)


def dense_oracle(model: Mapping[str, Linear], x: torch.Tensor,
                 y: torch.Tensor
                 ) -> Tuple[float, Dict[str, torch.Tensor], torch.Tensor]:
    """The same loss on the dense weights in float64 on ``x``'s device:
    (loss, dL/dW of each layer (d_in, d_out), dL/dh)."""
    dev = x.device
    ws = {k: torch.from_numpy(lin.to_dense()).to(dev, torch.float64)
          .requires_grad_() for k, lin in model.items()}
    xd, yd = x.detach().double(), y.detach().to(dev).double()
    h = torch.tanh(xd @ ws["l1"])
    h.retain_grad()
    loss = torch.mean((h @ ws["l2"] - yd) ** 2)
    loss.backward()
    return float(loss.detach()), {k: w.grad for k, w in ws.items()}, h.grad


def grad_errors(model: Mapping[str, Linear], x: torch.Tensor,
                y: torch.Tensor) -> Dict[str, float]:
    """Each layer's gradient on its live slots, and dL/dh, against the
    float64 dense oracle: max|err| / max|oracle|."""
    hidden = {}
    loss = mlp_loss(model, x, y, hidden=hidden)
    grads = torch.autograd.grad(loss, [lin.values for lin in model.values()]
                                + [hidden["h"]])
    _, ref, ref_h = dense_oracle(model, x, y)
    errs = {}
    for (name, lin), g in zip(model.items(), grads):
        dev = ref[name].device
        live = torch.from_numpy(lin.pattern.mask).to(dev)
        gd = torch.from_numpy(lin.to_dense(g)).to(dev, torch.float64)
        scale = max(float(ref[name].abs().max()), 1e-30)
        errs[name] = float((gd - ref[name])[live].abs().max()) / scale
    errs["dh"] = float((grads[-1].double() - ref_h).abs().max()) / \
        max(float(ref_h.abs().max()), 1e-30)
    return errs


def train_step(cfg: AdamWConfig, model: torch.nn.ModuleDict, state,
               x: torch.Tensor, y: torch.Tensor):
    """Loss, gradients of every ``values`` Parameter, one AdamW update.
    Returns (loss before the update, new state, metrics)."""
    params = dict(model.named_parameters())
    loss = mlp_loss(model, x, y)
    grads = torch.autograd.grad(loss, list(params.values()))
    _, state, metrics = adamw_update(cfg, dict(zip(params, grads)), state,
                                     params)
    return loss.detach(), state, metrics


def serve_check(lin: Linear, rng: np.random.Generator, *, n: int = 3,
                cols: int = 32, max_wave_cols: int = 256):
    """Serve ``lin`` through ``SpMMEngine`` on ``n`` requests; returns
    (the engine, the worst max|C - float64| / max|C|)."""
    eng = SpMMEngine(lin, max_wave_cols=max_wave_cols)
    reqs = [SpMMRequest(i, rng.normal(size=(lin.d_in, cols))
                        .astype(np.float32)) for i in range(n)]
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    if len(done) != n:
        raise RuntimeError(f"served {len(done)} of {n} requests")
    wt = lin.to_dense().astype(np.float64).T
    worst = 0.0
    for r in done:
        want = wt @ r.b.astype(np.float64)
        worst = max(worst, float(np.abs(r.out - want).max()) /
                    max(float(np.abs(want).max()), 1e-30))
    return eng, worst


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

    spec = student_spec(args.format, args.density, section=args.section,
                        block=args.block, bsr_block=args.bsr_block)
    model = torch.nn.ModuleDict({
        "l1": Linear.init(args.d_in, args.d_hidden, spec, scale=0.2,
                          generator=torch.Generator().manual_seed(1),
                          device=device),
        "l2": Linear.init(args.d_hidden, args.d_out, spec, scale=0.2,
                          generator=torch.Generator().manual_seed(2),
                          device=device)})
    nnz = sum(lin.nnz for lin in model.values())
    dense_n = args.d_in * args.d_hidden + args.d_hidden * args.d_out
    print(f"student ({args.format}): {nnz} trainable non-zeros "
          f"({nnz / dense_n:.1%} of the dense parameter count)")

    # grad sanity vs the float64 dense oracle, once at init
    errs = grad_errors(model, x, y)
    for name, err in errs.items():
        what = "dL/dh" if name == "dh" else "grad on live nnz"
        print(f"  {name}: max |{what} - dense oracle| = {err:.2e} of "
              f"max|oracle|")
        if not err <= GRAD_TOL:
            raise RuntimeError(f"{name}: gradient off the dense oracle by "
                               f"{err:.3e} > {GRAD_TOL} of its max")

    opt = AdamWConfig(lr=3e-3, weight_decay=0.0,
                      warmup_steps=max(2, args.steps // 10),
                      total_steps=args.steps)
    state = adamw_init(opt, dict(model.named_parameters()))
    t0 = time.perf_counter()
    losses = []
    for _ in range(args.steps):
        loss, state, _ = train_step(opt, model, state, x, y)
        losses.append(float(loss))
    train_s = time.perf_counter() - t0
    print(f"trained {args.steps} steps in {train_s:.1f}s: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not losses[-1] < losses[0]:
        raise RuntimeError("training must reduce the loss")

    # Deploy the trained first layer into the serving engine: the engine
    # takes the Linear itself (same values, no repacking).
    eng, served_err = serve_check(model["l1"], rng)
    if not served_err <= SERVE_TOL:
        raise RuntimeError(f"served results off float64 by {served_err:.3e}"
                           f" > {SERVE_TOL} of max|C|")
    print(f"served {eng.stats['requests']} requests on the trained operand "
          f"({eng.stats['waves']} waves, max rel err {served_err:.1e}) — "
          f"train->serve round trip OK")
    return {"format": args.format, "nnz": nnz, "grad_err": errs,
            "losses": losses, "train_s": train_s, "served_err": served_err,
            "waves": eng.stats["waves"]}


if __name__ == "__main__":
    main()
