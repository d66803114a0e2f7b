"""What the process-group tests run in each rank, and the same runs on the
one-process mesh beside them.

A rank is a process of ``repro_torch.launch.ranks.spawn`` on a gloo
process group of 4, its mesh ``make_process_mesh((2, 2), ("data",
"model"))``. The rank functions import no JAX (the card test uses them
too) and return numpy arrays, counts and flags for the parent to hold
against the one-process mesh of the same shape, on the same seeded
inputs.

* ``collectives_rank``: every case of ``CASES`` (each of the four
  collectives and ``all_reduce_max`` over "data", "model", both, and both
  in the reverse order), forward and backward; ``Sharded.full`` with a
  coordinate that holds no shard; the refusals (a mesh whose size is not
  the world's; NCCL's duplicate card).
* ``lm_rank``: granite-34b's smoke config, three AdamW steps with FSDP
  and ZeRO-1, a prefill and decode steps under the default rules and
  under JAX's serve overrides of its prefill cell (a context-parallel
  cache) on the long branch, and a ZeRO-1 step (layer-owned moments)
  saved from the process group and restored onto it.
* ``families_rank``: the MoE, SSD and RG-LRU families' smoke configs, a
  step each and a serve each (recurrentgemma-2b's under its overrides,
  sequence-parallel attention on the long branch), with the MoE routes.

``FLASH_THRESHOLD`` is lowered to the prompt's length for a serve on the
long branch (``serve_run``), in the rank and in the one-process run
alike, and put back after it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch.dryrun import cell_overrides
from repro_torch.launch.mesh import Mesh, make_process_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import sharding as sh
from repro_torch.models import spmd
from repro_torch.train import optimizer as O
from repro_torch.train import trainer as T
from repro_torch.train.zero import FSDP_OVERRIDES

SHAPE, AXES = (2, 2), ("data", "model")
WORLD = 4
X_SHAPE = (4, 8, 6)
# (name, spmd function, axes, dims)
CASES = [
    ("all_reduce_data", "all_reduce", ("data",), ()),
    ("all_reduce_model", "all_reduce", ("model",), ()),
    ("all_reduce_both", "all_reduce", ("data", "model"), ()),
    ("all_reduce_max_data", "all_reduce_max", ("data",), ()),
    ("all_reduce_max_model", "all_reduce_max", ("model",), ()),
    ("all_reduce_max_both", "all_reduce_max", ("data", "model"), ()),
    ("all_gather_data_0", "all_gather", ("data",), (0,)),
    ("all_gather_model_last", "all_gather", ("model",), (-1,)),
    ("all_gather_both_1", "all_gather", ("data", "model"), (1,)),
    ("all_gather_reversed_1", "all_gather", ("model", "data"), (1,)),
    ("reduce_scatter_data_1", "reduce_scatter", ("data",), (1,)),
    ("reduce_scatter_model_0", "reduce_scatter", ("model",), (0,)),
    ("reduce_scatter_both_1", "reduce_scatter", ("data", "model"), (1,)),
    ("reduce_scatter_reversed_0", "reduce_scatter", ("model", "data"),
     (0,)),
    ("all_to_all_data_1_2", "all_to_all", ("data",), (1, 2)),
    ("all_to_all_model_0_1", "all_to_all", ("model",), (0, 1)),
    ("all_to_all_both_1_0", "all_to_all", ("data", "model"), (1, 0)),
    ("all_to_all_reversed_0_2", "all_to_all", ("model", "data"), (0, 2)),
]
SUMS = ("all_reduce", "reduce_scatter")     # adds across the group
ADJOINT = {"all_reduce": "all_reduce", "all_gather": "reduce_scatter",
           "reduce_scatter": "all_gather", "all_to_all": "all_to_all"}


def axes_of(shape) -> tuple:
    return AXES[:len(shape)]


def cases_of(shape) -> list:
    """The names of the cases whose axes the mesh of ``shape`` has."""
    return [c[0] for c in CASES if set(c[2]) <= set(axes_of(shape))]


def one_process_mesh(device="cpu", shape=SHAPE) -> Mesh:
    return Mesh(np.full(shape, device, dtype=object), axes_of(shape))


def _draw(seed: int, shape, device) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(device)


def run_case(mesh, case, coords, device="cpu"):
    """Case ``case`` on ``mesh`` for the coordinates ``coords`` (every one
    in one process, the rank's under a process group): each coordinate's
    input drawn from its index, the cotangent of each output likewise;
    returns (outputs, input gradients or None, the collectives' counts)
    as numpy."""
    _, fn, axes, dims = CASES[[c[0] for c in CASES].index(case)]
    grad = fn != "all_reduce_max"
    xs = [_draw(100 + c, X_SHAPE, device).requires_grad_(grad)
          for c in coords]
    mesh.reset_collectives()
    ys = getattr(spmd, fn)(xs, mesh, axes, *dims)
    gs = None
    if grad:
        obj = sum((y * _draw(200 + c, tuple(y.shape), device)).sum()
                  for y, c in zip(ys, coords))
        gs = [g.detach().cpu().numpy() for g in
              torch.autograd.grad(obj, xs)]
    return ([y.detach().cpu().numpy() for y in ys], gs,
            {k: dict(v) for k, v in mesh.collectives.items()})


def exact(case: str, backward: bool) -> bool:
    """Whether the one-process and the process-group results of a case
    must be equal bit for bit: a group of 2 adds a + b either way, and a
    gather or an all-to-all only moves values; a sum over a group of 4
    may add in another order."""
    _, fn, axes, _ = CASES[[c[0] for c in CASES].index(case)]
    if backward:
        fn = ADJOINT[fn]
    return len(axes) == 1 or fn not in SUMS


def collectives_rank(rank: int, device: str = "cpu", shape=SHAPE):
    torch.set_num_threads(1)
    axes = axes_of(shape)
    mesh = make_process_mesh(shape, axes, device=device)
    out = {"rank": rank, "coords": spmd.local_coords(mesh),
           "stage_on_host": mesh.stage_on_host,
           "cases": {name: run_case(mesh, name, [rank], device)
                     for name in cases_of(shape)}}
    # full(): every coordinate's shard, and a region held by the
    # coordinates of data index 0 alone (the others hold None, as a
    # non-owner of a layer's moments does)
    t = _draw(7, (4, 6), device)
    s = spmd.place(t, mesh, ("data", axes[-1] if len(axes) > 1 else None))
    out["full_equal"] = bool(torch.equal(s.full(), t))
    part = spmd.place(t, mesh, (None, axes[-1] if len(axes) > 1 else None))
    if mesh.coords()[rank]["data"] == 1:
        part.shards = [None]
    out["full_partial_equal"] = bool(torch.equal(part.full(), t))
    at_root = part.full(root=0)
    out["full_root_ok"] = (bool(torch.equal(at_root, t)) if rank == 0
                           else at_root is None)
    out["refusals"] = _refusals(device, shape)
    return out


def _refusals(device, shape):
    """The constructor's refusals, each message (or None where it did not
    raise): a mesh of twice the world's size; two ranks on one card under
    NCCL (the backend's name stood in for: NCCL needs cards)."""
    import torch.distributed as dist
    got = {}
    try:
        make_process_mesh((2 * int(np.prod(shape)),), ("data",),
                          device=device)
        got["world"] = None
    except ValueError as e:
        got["world"] = str(e)
    real = dist.get_backend
    dist.get_backend = lambda *a, **k: "nccl"
    try:
        Mesh(np.full(shape, "cuda:0", dtype=object), axes_of(shape),
             process_group=True)
        got["nccl_shared_card"] = None
    except ValueError as e:
        got["nccl_shared_card"] = str(e)
    finally:
        dist.get_backend = real
    return got


# ----------------------------------------------------------------------
# The LM slice: granite-34b's smoke config in f32.
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
PROMPT, DECODES = 20, 6


def model_of(cfg, weights, device="cpu") -> M.Model:
    """A one-device ``Model`` holding ``weights`` ({name: array})."""
    model = M.Model(cfg, device=device)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(
                model.named_buffers()):
            t.copy_(torch.as_tensor(weights[name]))
    return model


def _host(d):
    return {k: v.detach().cpu().numpy() for k, v in d.items()}


def train_run(cfg, weights, batches, mesh, rules, device="cpu"):
    """AdamW steps of ``batches`` under ``rules`` (FSDP added): each step's
    loss, norm and collectives, and the parameters after them."""
    opt = O.AdamWConfig(**OPT)
    rules = dict(FSDP_OVERRIDES, **(rules or {}))
    sm = spmd.shard_model(model_of(cfg, weights, device), mesh, rules)
    steps = []
    with sh.axis_rules(mesh, rules):
        step = T.build_train_step(cfg, opt)
        state = T.init_sharded_opt_state(opt, sm)
        for b in batches:
            mesh.reset_collectives()
            sm, state, m = step(sm, state, b)
            steps.append({
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "collectives": {k: dict(v) for k, v in
                                mesh.collectives.items()}})
    return steps, _host({k: p.full() for k, p in sm.params.items()})


def serve_run(cfg, weights, toks, feed, mesh, rules=None, device="cpu",
              long=False):
    """A prefill of ``toks`` and a decode step a column of ``feed`` under
    ``rules``; ``long``: on the long branch (``FLASH_THRESHOLD`` lowered
    to the prompt's length, flash chunks of 8). The logits of each call,
    its joined MoE routes (``topi``), the collectives, the cache's end
    and the first attention cache's spec."""
    if long:
        cfg = dataclasses.replace(cfg, flash_chunk=8)
    sm = spmd.shard_model(model_of(cfg, weights, device), mesh, rules)
    b, s = toks.shape
    alloc = s + feed.shape[1]
    calls = [lambda c: M.prefill_step(sm, torch.as_tensor(toks),
                                      alloc_seq=alloc,
                                      cache_dtype=torch.float32)]
    calls += [lambda c, t=t: M.decode_step(
        sm, torch.as_tensor(feed[:, t:t + 1]), c, pos=s + t)
        for t in range(feed.shape[1])]
    old = L.FLASH_THRESHOLD
    if long:
        L.FLASH_THRESHOLD = s
    mesh.reset_collectives()
    cache, logits, routes = None, [], []
    try:
        for call in calls:
            sm.route_log = []
            lg, cache = call(cache)
            logits.append(lg.full().cpu().numpy())
            routes.append([r.topi.cpu().numpy()
                           for _, r in sm.joined_routes(b)])
    finally:
        L.FLASH_THRESHOLD = old
    attn = next((c for c in cache if "k" in c), None)
    return {"logits": logits, "routes": routes,
            "collectives": {k: dict(v) for k, v in
                            mesh.collectives.items()},
            "cache_end": int(cache[0]["end"]),
            "cache_spec": None if attn is None else list(attn["k"].spec)}


def lm_run(cfg, weights, batches, toks, feed, mesh, ckpt_dir=None,
           device="cpu"):
    """The slice on ``mesh`` (one process or a process group): three
    AdamW steps with FSDP and ZeRO-1 (each step's loss, norm and
    collectives; the parameters after them), a prefill of ``toks`` and a
    decode step a column of ``feed`` under the default rules, the same
    under the prefill cell's overrides on the long branch
    (``serve_overrides``), and with ``ckpt_dir`` a ZeRO-1 step without
    FSDP saved there at step 1 (the saved state gathered, the moments'
    holders)."""
    out = {}
    out["steps"], out["params"] = train_run(cfg, weights, batches, mesh, {},
                                            device)
    out["serve"] = serve_run(cfg, weights, toks, feed, mesh, None, device)
    out["serve_overrides"] = serve_run(
        cfg, weights, toks, feed, mesh,
        cell_overrides(configs.get("granite-34b"), "prefill"), device,
        long=True)
    if ckpt_dir is not None:
        out["checkpoint"] = _zero1_save(cfg, weights, batches[0], mesh,
                                        ckpt_dir, device)
    return out


def _zero1_save(cfg, weights, batch, mesh, ckpt_dir, device):
    """One ZeRO-1 step without FSDP (each data coordinate owns whole
    layers' moments), saved at step 1; then restored onto a fresh template
    on the same mesh. Returns the saved state gathered, which coordinates
    the process runs hold each moment, and whether the restored shards
    equal the saved ones bit for bit."""
    opt = O.AdamWConfig(**OPT)
    sm = spmd.shard_model(model_of(cfg, weights, device), mesh, {})
    with sh.axis_rules(mesh, {}):
        step = T.build_train_step(cfg, opt)
        st = T.init_sharded_opt_state(opt, sm)
        sm, st, _ = step(sm, st, batch)
        ck = CheckpointManager(ckpt_dir, async_write=False)
        ck.save(1, {"params": sm, "opt": st})
        # gathered to rank 0, as the save gathers them
        saved = {"params": _at_root({k: p.full(root=0) for k, p in
                                     sm.params.items()}),
                 "m": _at_root({k: x.full(root=0)
                                for k, x in st["m"].items()})}
        held = {k: [t is not None for t in x.shards]
                for k, x in st["m"].items()}
        fresh = spmd.shard_model(M.Model(cfg, device=device), mesh, {})
        st2 = T.init_sharded_opt_state(opt, fresh)
        tree = CheckpointManager(ckpt_dir, async_write=False).restore(
            1, {"params": fresh, "opt": st2})
        same = all(torch.equal(a, b) for k in sm.params for a, b in
                   zip(sm.params[k].shards, tree["params"].params[k].shards))
        for k, x in st["m"].items():
            for a, b in zip(x.shards, tree["opt"]["m"][k].shards):
                same &= (a is None) == (b is None) and (
                    a is None or torch.equal(a, b))
    return {"saved": saved, "held": held, "restored_equal": bool(same)}


def _at_root(d):
    """``_host(d)`` where ``d`` holds tensors, None where a gather to
    another rank left it Nones."""
    if all(v is None for v in d.values()):
        return None
    return _host(d)


def lm_rank(rank: int, cfg, weights, batches, toks, feed, ckpt_dir,
            device: str = "cpu"):
    torch.set_num_threads(1)
    mesh = make_process_mesh(SHAPE, AXES, device=device)
    out = lm_run(cfg, weights, batches, toks, feed, mesh, ckpt_dir, device)
    out["rank"] = rank
    if rank:        # every rank gathered them; one copy comes back
        out.pop("params")
    return out


# (smoke config, rules of the serve, on the long branch)
FAMILIES = {"mixtral-8x7b": (None, False), "mamba2-370m": (None, False),
            "recurrentgemma-2b": (cell_overrides(
                configs.get("recurrentgemma-2b"), "prefill"), True)}


def families_run(cases, mesh, device="cpu"):
    """Per family of ``FAMILIES``: (cfg, weights, batch, toks, feed) in
    ``cases`` run as one AdamW step with FSDP (``train_run``) and a serve
    (``serve_run``) under the family's rules."""
    out = {}
    for arch, (cfg, weights, batch, toks, feed) in cases.items():
        rules, long = FAMILIES[arch]
        steps, params = train_run(cfg, weights, [batch], mesh, {}, device)
        out[arch] = {"steps": steps, "params": params,
                     "serve": serve_run(cfg, weights, toks, feed, mesh,
                                        rules, device, long=long)}
    return out


def families_rank(rank: int, cases, device: str = "cpu"):
    torch.set_num_threads(1)
    mesh = make_process_mesh(SHAPE, AXES, device=device)
    out = families_run(cases, mesh, device)
    if rank:        # every rank gathered them; one copy comes back
        for r in out.values():
            r.pop("params")
    return {"rank": rank, "families": out}


# ----------------------------------------------------------------------
# ranks that fail: ``spawn`` must fail with them
def raising_rank(rank: int):
    raise RuntimeError(f"rank {rank} fails on purpose")


def sleeping_rank(rank: int, seconds: float):
    if rank == 1:
        import time
        time.sleep(seconds)
    return rank
