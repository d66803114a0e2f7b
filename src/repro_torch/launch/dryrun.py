"""One-card dry run: what every (arch x shape) cell holds on one 80 GB card.

  python -m repro_torch.launch.dryrun --arch granite-34b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--json FILE] [--device cpu]

The counterpart of ``repro.launch.dryrun`` for one controlling process on
one card. JAX lowers and compiles each cell on a mesh of fake TPU devices
and reads the compiler's memory analysis and the collectives' bytes; here
nothing is compiled (PyTorch runs eagerly) and one card has no collective,
so neither is reported. Each cell that ``configs.shapes.applicable``
admits is built at full width on ``torch.device("meta")``, which allocates
nothing (``launch.specs``), and reports exact bytes:

* ``params``: every parameter in ``param_dtype`` (the port trains and
  serves from those; serving casts at use);
* ``grads`` (train): the f32 sum of the microbatches' gradients
  (``trainer.loss_and_grads``) and one microbatch's in ``param_dtype``;
* ``opt`` (train): the AdamW state at ``specs.default_opt`` (int8
  moments above 100 B parameters);
* ``cache`` (prefill, decode): the decode cache of ``global_batch``
  sequences of ``seq_len`` positions in ``cfg.dtype``;
* ``acts`` (train): what autograd keeps for one microbatch's forward
  (``global_batch / default_n_micro``) under the trainer's remat, measured
  on the meta device: the tensors the forward saves, through
  ``torch.autograd.graph.saved_tensors_hooks`` (parameters not counted
  again), plus the products the ``"dots"`` policy keeps in each
  checkpointed block (the outputs of ``model._SAVED_PRODUCTS``).
  Prefill and decode cells do not estimate activations.

The total is held against the card's memory (``torch.cuda``'s, or 80 GB
stated as such where there is no card), with the most layers at which the
cell fits. Every term is a fixed part plus the same bytes a group of
``block_pattern`` layers, so each is measured at one group and at two and
taken to full depth from them (exact: the tests hold it against a
measurement at full depth).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import configs
from ..configs.shapes import SHAPES, ShapeSpec, applicable
from ..models import layers
from ..models import model as M
from ..models.config import ModelConfig
from . import specs

CARD_BYTES_STATED = 80 * 10 ** 9      # an H100's 80 GB, where none is read
ACTS_NOT_ESTIMATED = "activations not estimated"


class _Products(TorchDispatchMode):
    """Bytes of the outputs of the ops the "dots" remat policy keeps."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in M._SAVED_PRODUCTS:
            self.nbytes += out.numel() * out.element_size()
        return out


def saved_bytes(cfg: ModelConfig, batch: int, seq_len: int) -> int:
    """Bytes autograd keeps after one forward of ``loss_fn`` with remat on
    a (batch, seq_len) microbatch, measured on the meta device."""
    model = specs.meta_model(cfg)
    params = {p.untyped_storage()._cdata for p in model.parameters()}
    seen: Dict[int, int] = {}

    def pack(t):
        st = t.untyped_storage()
        if st._cdata not in params:
            seen[st._cdata] = max(seen.get(st._cdata, 0), st.nbytes())
        return t

    shape = ShapeSpec("microbatch", seq_len, batch, "train")
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        M.loss_fn(model, specs.batch_specs(cfg, shape), remat=True)
    kept = 0
    if cfg.remat_policy == "dots":
        s = seq_len + (cfg.n_prefix_embeds if cfg.input_mode == "embeds"
                       else 0)
        x = torch.empty((batch, s, cfg.d_model),
                        dtype=layers.torch_dtype(cfg.dtype),
                        device=specs.META)
        pos = torch.arange(s, device=specs.META).expand(batch, s)
        count = _Products()
        with torch.no_grad(), count:
            for blk in model.blocks:
                x = M._train_block(blk, x, pos)
        kept = count.nbytes
    return sum(seen.values()) + kept


def _terms(cfg: ModelConfig, shape: ShapeSpec, full: ModelConfig
           ) -> Dict[str, Optional[int]]:
    """The bytes of ``cfg`` (``full`` cut in depth) in a ``shape`` cell,
    at the microbatches and optimizer ``full`` takes."""
    params = specs.params_specs(cfg)
    p_bytes = specs.tree_bytes(params)
    out: Dict[str, Optional[int]] = {"params": p_bytes, "grads": 0,
                                     "opt": 0, "cache": 0, "acts": None}
    if shape.kind == "train":
        n_micro = specs.default_n_micro(full)
        f32 = sum(p.numel() * 4 for p in params.values())
        out["grads"] = f32 + (p_bytes if n_micro > 1 else 0)
        out["opt"] = specs.tree_bytes(
            specs.opt_specs(specs.default_opt(full), params))
        out["acts"] = saved_bytes(cfg, shape.global_batch // n_micro,
                                  shape.seq_len)
    else:
        out["cache"] = specs.tree_bytes(specs.cache_specs(
            cfg, shape.global_batch, shape.seq_len,
            layers.torch_dtype(cfg.dtype)))
    return out


def card_bytes(device: str) -> tuple:
    """(bytes, what they are) of one card's memory."""
    if device != "cpu" and torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return props.total_memory, f"{props.name} (torch.cuda)"
    if device != "cpu":
        raise RuntimeError("CUDA is not available; the dry run reads the "
                           "card's memory unless the caller passes "
                           "--device cpu")
    return CARD_BYTES_STATED, "80 GB stated (no card read)"


def run_cell(arch: str, shape_name: str, *, device: str = "cuda") -> dict:
    """The row of one applicable cell (``ValueError`` for one that is
    not)."""
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} x {shape_name} is not a cell: {why}")
    period = len(cfg.block_pattern)
    groups = cfg.n_layers // period
    one, two = (_terms(dataclasses.replace(cfg, n_layers=g * period), shape,
                       cfg) for g in (1, 2))
    # every term is a fixed part plus the same bytes a group: full depth
    # from one and two groups (exact; tests hold it against full depth)
    full = {k: None if v is None else v + (groups - 1) * (two[k] - v)
            for k, v in one.items()}
    total = sum(v or 0 for v in full.values())
    per_group = sum(v or 0 for v in two.values()) - \
        sum(v or 0 for v in one.values())
    fixed = total - groups * per_group
    cap, source = card_bytes(device)
    if per_group > 0:
        fit = max(0, min(groups, (cap - fixed) // per_group))
    else:
        fit = groups if total <= cap else 0
    row = {"arch": arch, "shape": shape_name, "kind": shape.kind,
           "n_layers": cfg.n_layers, "global_batch": shape.global_batch,
           "seq_len": shape.seq_len,
           **{f"{k}_bytes": v for k, v in full.items()},
           "total_bytes": total, "card_bytes": cap, "card": source,
           "fits": total <= cap, "max_layers": int(fit) * period,
           "bytes_per_group": per_group, "fixed_bytes": fixed}
    if shape.kind == "train":
        row["n_micro"] = specs.default_n_micro(cfg)
        row["microbatch"] = shape.global_batch // row["n_micro"]
        row["opt_int8"] = specs.default_opt(cfg).quantize
    else:
        row["acts_note"] = ACTS_NOT_ESTIMATED
    return row


def cells() -> List[tuple]:
    """Every (arch, shape) that ``applicable`` admits, in registry order."""
    return [(a, s) for a in configs.ARCH_NAMES for s in SHAPES
            if applicable(configs.get(a), SHAPES[s])[0]]


def _gb(n) -> str:
    return "-" if n is None else f"{n / 1e9:.2f}"


def format_row(r: dict) -> str:
    return (f"{r['arch']:<20} {r['shape']:<12} params {_gb(r['params_bytes'])}"
            f" grads {_gb(r['grads_bytes'])} opt {_gb(r['opt_bytes'])} cache"
            f" {_gb(r['cache_bytes'])} acts {_gb(r['acts_bytes'])} = "
            f"{_gb(r['total_bytes'])} GB of {_gb(r['card_bytes'])}: "
            f"{'fits' if r['fits'] else 'does not fit'}, "
            f"{r['max_layers']} of {r['n_layers']} layers fit")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=configs.ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every applicable arch x shape cell")
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="write the rows as JSON")
    ap.add_argument("--device", default="cuda",
                    help="whose memory to hold the cells against: cuda "
                         "(the card's) or cpu (80 GB stated)")
    args = ap.parse_args(argv)
    if args.all == bool(args.arch or args.shape) or \
            (not args.all and not (args.arch and args.shape)):
        ap.error("give --all, or both --arch and --shape")
    todo = cells() if args.all else [(args.arch, args.shape)]
    rows = [run_cell(a, s, device=args.device) for a, s in todo]
    for r in rows:
        print(format_row(r))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"cells": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
