"""Dry run: what every (arch x shape) cell holds on one 80 GB card, or on
one device of JAX's 16 x 16 or 2 x 16 x 16 mesh.

  python -m repro_torch.launch.dryrun --arch granite-34b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--json FILE] [--device cpu]
  python -m repro_torch.launch.dryrun --all --single-pod | --multi-pod |
      --both-meshes

The counterpart of ``repro.launch.dryrun`` for one controlling process.
JAX lowers and compiles each cell on a mesh of fake TPU devices and reads
the compiler's memory analysis and the collectives' bytes; here nothing
is compiled (PyTorch runs eagerly).

On a mesh (``run_mesh_cell``) each cell takes JAX's overrides for it
(``cell_overrides``: ``FSDP_OVERRIDES`` for train, ``serve_rules``
otherwise, and ``default_overrides``) and reports per device the exact
bytes of params, grads, AdamW state and cache from their shard shapes
(``mesh_bytes``), held against one card's memory, and the collectives
of one step, prefill or decode by kind, from a run on a mesh of ``meta``
devices (``mesh_collectives``: one and two groups of ``block_pattern``
taken to full depth), under every override of the cell: the serve cells
with a context-parallel KV cache (``cache_seq``) and, where the 16-way
model axis does not divide the heads, sequence-parallel attention
(``attn_q_seq``). The meta run reads no value: nothing in the sharded
forward, the MoE's routing included, turns a tensor into a host number.

Without a mesh flag, the one-card report: each cell that
``configs.shapes.applicable`` admits is built at full width on
``torch.device("meta")``, which allocates nothing (``launch.specs``), and
reports exact bytes:

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
import copy
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
from ..models import sharding as sh
from ..models import spmd
from ..models.config import ModelConfig
from ..train import optimizer, trainer, zero
from . import specs
from .mesh import make_production_mesh

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


# ----------------------------------------------------------------------
# The mesh dry run: what one device of JAX's production meshes holds.
MESHES = {"16x16": False, "2x16x16": True}      # name -> multi_pod


def serve_rules(cfg: ModelConfig) -> dict:
    """JAX's serve-shape overrides: the KV cache's positions over "model",
    and 2-D weight sharding (embed over "data" too) where bf16 parameters
    over 16 model shards would pass 8 GB a device."""
    rules = {"cache_seq": "model"}
    if cfg.param_count() * 2 / 16 > 8e9:
        rules["embed"] = "data"
    return rules


def default_overrides(cfg: ModelConfig, kind: str) -> dict:
    """JAX's default overrides: sequence-parallel attention (``attn_q_seq``
    over "model") where the 16-way model axis does not divide the heads,
    for serve shapes and internvl2-1b's train cell."""
    out = {}
    if cfg.n_heads and cfg.n_heads % 16 != 0:
        if kind != "train" or cfg.name == "internvl2-1b":
            out["attn_q_seq"] = "model"
    return out


def cell_overrides(cfg: ModelConfig, kind: str) -> dict:
    """The rule overrides of a cell, as JAX's dry run takes them:
    ``default_overrides`` and ``FSDP_OVERRIDES`` (train) or
    ``serve_rules`` (prefill, decode)."""
    out = default_overrides(cfg, kind)
    out.update(zero.FSDP_OVERRIDES if kind == "train" else serve_rules(cfg))
    return out


def _shard_bytes(shape, spec, sizes, itemsize: int) -> int:
    n = 1
    for d in sh.shard_shape(shape, spec, sizes):
        n *= d
    return n * itemsize


def mesh_bytes(cfg: ModelConfig, shape: ShapeSpec, sizes, rules
               ) -> Dict[str, int]:
    """Per-device bytes of a cell on a mesh of ``sizes`` under ``rules``,
    exact from shard shapes: ``params`` (``param_dtype``), ``grads``
    (train: the f32 sum and, with microbatches, one microbatch's in
    ``param_dtype``, each of the parameter's shard shape), ``opt`` (train:
    both moments by ``trainer.moment_specs_of`` at ``specs.default_opt``,
    ZeRO-1 on, and the count) and ``cache`` (prefill, decode: k and v of
    every attention layer by ``init_cache_axes``, in ``cfg.dtype``; the
    recurrent layers' state and conv tail)."""
    params = specs.params_specs(cfg)
    axes = M.init_axes(cfg)
    pspec = {k: sh.resolve_with(rules, sizes, axes[k], tuple(p.shape))
             for k, p in params.items()}
    psize = layers.torch_dtype(cfg.param_dtype).itemsize
    out = {"params": sum(_shard_bytes(p.shape, pspec[k], sizes, psize)
                         for k, p in params.items()),
           "grads": 0, "opt": 0, "cache": 0}
    if shape.kind == "train":
        f32 = sum(_shard_bytes(p.shape, pspec[k], sizes, 4)
                  for k, p in params.items())
        out["grads"] = f32 + (out["params"] if specs.default_n_micro(cfg) > 1
                              else 0)
        opt = specs.default_opt(cfg)
        ms = trainer.moment_specs_of(opt, axes, {k: p.shape for k, p in
                                                 params.items()},
                                     rules, sizes, n_groups=cfg.n_groups)
        # JAX's stacked moments: a block parameter's spec has the stack's
        # entry, so its bytes are counted on (n_groups, ...) and the sum
        # over its n_groups layers' names divided by n_groups
        flat, stacked = 0, 0
        for k, p in params.items():
            block = k.startswith("blocks.")
            full = ((cfg.n_groups,) if block else ()) + tuple(p.shape)
            if opt.quantize:
                n = _shard_bytes(full, ms[k]["q"], sizes, 1) + _shard_bytes(
                    optimizer.scale_shape(full), ms[k]["s"], sizes, 4)
            else:
                n = _shard_bytes(full, ms[k], sizes, 4)
            if block:
                stacked += n
            else:
                flat += n
        out["opt"] = 2 * (flat + stacked // cfg.n_groups) + 4
    else:
        cdt = layers.torch_dtype(cfg.dtype)
        cache = specs.cache_specs(cfg, shape.global_batch, shape.seq_len,
                                  cdt)
        for c, cax in zip(cache, M.init_cache_axes(cfg)):
            for k, ax in cax.items():
                t = c[k]
                out["cache"] += _shard_bytes(
                    t.shape, sh.resolve_with(rules, sizes, ax,
                                             tuple(t.shape)),
                    sizes, t.element_size())
    return out


def _collectives_once(cfg: ModelConfig, shape: ShapeSpec, mesh,
                      overrides: dict, full: ModelConfig):
    """The collectives of one run of ``cfg`` on the meta ``mesh``, and of
    its update (train; else None): train, one microbatch's forward and
    backward (remat on), then the gradient reductions and the update;
    prefill, the prompt into a cache of ``seq_len`` slots; decode, one
    token against a full cache."""
    model = spmd.shard_model(M.Model(cfg, device=specs.META), mesh,
                             overrides)
    b, s = shape.global_batch, shape.seq_len
    cdt = layers.torch_dtype(cfg.dtype)
    mesh.reset_collectives()
    opt_counts = None
    if shape.kind == "train":
        nm = specs.default_n_micro(full)
        micro = ShapeSpec("microbatch", s, b // nm, "train")
        _, grads = trainer.sharded_loss_and_grads(
            model, specs.batch_specs(cfg, micro), remat=True)
        step = copy.deepcopy(mesh.collectives)
        mesh.reset_collectives()
        opt = specs.default_opt(full)
        ms = trainer.moment_specs(opt, model)
        state = optimizer.sharded_adamw_init(opt, model, ms)
        optimizer.sharded_adamw_update(
            opt, trainer.reduce_grads(model, grads, ms), state, model, ms)
        opt_counts = copy.deepcopy(mesh.collectives)
    elif shape.kind == "prefill":
        pfx = None
        if cfg.input_mode == "embeds":
            pfx = torch.empty((b, cfg.n_prefix_embeds, cfg.d_model),
                              dtype=cdt, device=specs.META)
        M.prefill_step(model, torch.empty((b, s), dtype=torch.int32,
                                          device=specs.META),
                       prefix_embeds=pfx, alloc_seq=s, cache_dtype=cdt)
        step = copy.deepcopy(mesh.collectives)
    else:
        cache = model.init_cache(b, s, cdt)
        for c in cache:
            c["end"] = s - 1
        M.decode_step(model, torch.empty((b, 1), dtype=torch.int32,
                                         device=specs.META), cache,
                      pos=s - 1)
        step = copy.deepcopy(mesh.collectives)
    return step, opt_counts


def mesh_collectives(cfg: ModelConfig, shape: ShapeSpec, mesh,
                     overrides: dict) -> Dict[str, Dict[str, float]]:
    """Per-device collective count, result and wire bytes by kind of one
    step (train: ``default_n_micro`` microbatches and the update) or one
    prefill or decode call of ``cfg`` on the meta ``mesh``: run at
    one and two groups of ``block_pattern`` and taken to full depth (each
    is a fixed part plus the same a group, as JAX's ``roofline_cell``
    takes it), the microbatch's part times the microbatches."""
    period = len(cfg.block_pattern)
    runs = [_collectives_once(dataclasses.replace(cfg, n_layers=g * period),
                              shape, mesh, overrides, cfg) for g in (1, 2)]
    nm = specs.default_n_micro(cfg) if shape.kind == "train" else 1
    out = {}
    for kind in spmd.KINDS:
        out[kind] = {}
        for key in ("count", "result_bytes", "wire_bytes"):
            total = 0
            for part, scale in ((0, nm), (1, 1)):
                one, two = (r[part] for r in runs)
                if one is None:
                    continue
                b = two[kind][key] - one[kind][key]
                total += scale * (one[kind][key] + (cfg.n_groups - 1) * b)
            out[kind][key] = total
    return out


def run_mesh_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                  device: str = "cuda") -> dict:
    """The row of one applicable cell on JAX's 16 x 16 mesh (or 2 x 16 x
    16 with ``multi_pod``): its overrides, per-device bytes
    (``mesh_bytes``) against one card's memory, and the per-device
    collectives of a meta-device run (``mesh_collectives``) under the
    same overrides."""
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} x {shape_name} is not a cell: {why}")
    mesh = make_production_mesh(multi_pod=multi_pod, device=specs.META)
    overrides = cell_overrides(cfg, shape.kind)
    rules = sh.filter_rules(mesh, overrides)
    nbytes = mesh_bytes(cfg, shape, mesh.shape, rules)
    total = sum(nbytes.values())
    cap, source = card_bytes(device)
    row = {"arch": arch, "shape": shape_name, "kind": shape.kind,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "n_devices": mesh.size, "overrides": overrides,
           **{f"{k}_bytes": v for k, v in nbytes.items()},
           "acts_note": ACTS_NOT_ESTIMATED,
           "total_bytes": total, "card_bytes": cap, "card": source,
           "fits": total <= cap}
    if shape.kind == "train":
        row["n_micro"] = specs.default_n_micro(cfg)
        row["opt_int8"] = specs.default_opt(cfg).quantize
    coll = mesh_collectives(cfg, shape, mesh, overrides)
    row.update(collectives=coll,
               wire_bytes_per_device=sum(v["wire_bytes"]
                                         for v in coll.values()))
    return row


def format_mesh_row(r: dict) -> str:
    head = (f"[{r['mesh']}] {r['arch']:<20} {r['shape']:<12} params "
            f"{_gb(r['params_bytes'])} grads {_gb(r['grads_bytes'])} opt "
            f"{_gb(r['opt_bytes'])} cache {_gb(r['cache_bytes'])} = "
            f"{_gb(r['total_bytes'])} GB a device of "
            f"{_gb(r['card_bytes'])}: "
            f"{'fits' if r['fits'] else 'does not fit'}")
    coll = r["collectives"]
    kinds = ", ".join(f"{k} {int(v['count'])} x {v['wire_bytes'] / 1e9:.3f}"
                      for k, v in coll.items() if v["count"])
    return (f"{head}; wire {r['wire_bytes_per_device'] / 1e9:.3f} GB a "
            f"device ({kinds} GB)")


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
    ap.add_argument("--single-pod", action="store_true",
                    help="per device of JAX's 16 x 16 mesh instead of one "
                         "card")
    ap.add_argument("--multi-pod", action="store_true",
                    help="per device of JAX's 2 x 16 x 16 mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="both meshes")
    args = ap.parse_args(argv)
    if args.all == bool(args.arch or args.shape) or \
            (not args.all and not (args.arch and args.shape)):
        ap.error("give --all, or both --arch and --shape")
    todo = cells() if args.all else [(args.arch, args.shape)]
    meshes = [m for m, on in (("16x16", args.single_pod or args.both_meshes),
                              ("2x16x16", args.multi_pod or
                               args.both_meshes)) if on]
    if not meshes:
        rows = [run_cell(a, s, device=args.device) for a, s in todo]
        for r in rows:
            print(format_row(r))
    else:
        rows = []
        for name in meshes:
            for a, s in todo:
                rows.append(run_mesh_cell(a, s, multi_pod=MESHES[name],
                                          device=args.device))
                print(format_mesh_row(rows[-1]), flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"cells": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
