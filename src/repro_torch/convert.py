"""Carry an operand's or a model's state across from the JAX package.

The system's state is the sparse operand, a sparse layer's values and
metadata, its optimizer state, or an LM's weights. These take the fields
of a ``repro`` ``CRS``, ``InCRS``, ``BSR``, ``PreparedOperand``, per-round
prep, sparse-linear params, AdamW state or model params as numpy arrays
(``np.asarray`` of each) and lists, and build the port's objects from
them, so both packages can be fed the same operand or weights, and a JAX
training run can go on in the port.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .core.bsr import BSR
from .core.crs import CRS
from .core.incrs import InCRS
from .kernels.ops import PreparedOperand, resolve_device


def crs_from_arrays(values, col_idx, row_ptr,
                    shape: Tuple[int, int]) -> CRS:
    """The port's ``CRS`` from its three arrays."""
    values = np.asarray(values)
    col_idx, row_ptr = np.asarray(col_idx), np.asarray(row_ptr)
    m = int(shape[0])
    if values.ndim != 1 or values.shape != col_idx.shape \
            or row_ptr.shape != (m + 1,):
        raise ValueError(f"CRS arrays disagree: values {values.shape}, "
                         f"col_idx {col_idx.shape}, row_ptr {row_ptr.shape} "
                         f"for {m} rows")
    return CRS(values, col_idx.astype(np.int32), row_ptr.astype(np.int64),
               (m, int(shape[1])))


def incrs_from_arrays(values, col_idx, row_ptr, shape: Tuple[int, int],
                      counters, section: int, block: int) -> InCRS:
    """The port's ``InCRS`` from the CRS arrays and packed counter words."""
    counters = np.asarray(counters)
    if counters.dtype != np.uint32 or counters.ndim != 3 \
            or counters.shape[-1] != 2:
        raise ValueError(f"counters must be (M, n_sections, 2) uint32, got "
                         f"{counters.shape} {counters.dtype}")
    return InCRS(crs_from_arrays(values, col_idx, row_ptr, shape), counters,
                 int(section), int(block))


def prepared_from_arrays(idx, val, shape: Tuple[int, int], section: int,
                         device=None) -> PreparedOperand:
    """The port's ``PreparedOperand`` on ``device`` from stripe arrays."""
    idx, val = np.asarray(idx), np.asarray(val)
    if idx.dtype != np.int32 or val.dtype != np.float32 \
            or idx.shape != val.shape or idx.ndim != 3:
        raise ValueError(f"stripes must be two (Mp, n_sections, smax) "
                         f"int32/float32 arrays, got {idx.shape} "
                         f"{idx.dtype} and {val.shape} {val.dtype}")
    dev = resolve_device(device)
    return PreparedOperand(torch.from_numpy(idx.copy()).to(dev),
                           torch.from_numpy(val.copy()).to(dev),
                           (int(shape[0]), int(shape[1])), int(section))


def rounds_from_arrays(idx, val, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A per-round prep ``(idx, val)`` (``ops.prep_rounds`` form) as the
    port's tensors on ``device``."""
    idx, val = np.asarray(idx), np.asarray(val)
    if idx.dtype != np.int32 or idx.ndim != 3 or idx.shape != val.shape \
            or val.dtype.kind != "f":
        raise ValueError(f"a round prep is an int32 idx and a float val of "
                         f"one (rows, n_rounds, rmax) shape, got {idx.shape} "
                         f"{idx.dtype} and {val.shape} {val.dtype}")
    dev = resolve_device(device)
    return (torch.from_numpy(idx.copy()).to(dev),
            torch.from_numpy(val.copy()).to(dev))


def bsr_from_arrays(values, col_idx, row_ptr, shape: Tuple[int, int],
                    block: Tuple[int, int]) -> BSR:
    """The port's ``BSR`` from its three arrays."""
    values = np.asarray(values)
    col_idx, row_ptr = np.asarray(col_idx), np.asarray(row_ptr)
    bm, bk = (int(x) for x in block)
    m, k = (int(x) for x in shape)
    if m % bm or k % bk or values.ndim != 3 \
            or values.shape[1:] != (bm, bk) \
            or col_idx.shape != (values.shape[0],) \
            or row_ptr.shape != (m // bm + 1,):
        raise ValueError(f"BSR arrays disagree: values {values.shape}, "
                         f"col_idx {col_idx.shape}, row_ptr {row_ptr.shape} "
                         f"for shape {(m, k)} in blocks {(bm, bk)}")
    return BSR(values, col_idx.astype(np.int32), row_ptr.astype(np.int32),
               (m, k), (bm, bk))


def pattern_from_jax(pattern):
    """The port's ``SparsityPattern`` from a JAX one (or anything with a
    ``mask`` and a ``version``): the element mask and the version, so the
    two lineages repack to the same versions. The ``uid`` is the port's
    own."""
    from .sparse.pattern import SparsityPattern
    return SparsityPattern(np.array(pattern.mask, bool),
                           int(pattern.version))


_BSR_META_TUPLES = ("row_of", "col_of", "vpos", "t_perm", "t_row_of",
                    "t_col_of", "t_vpos")


def linear_from_jax(values, meta_fields: Dict[str, Any], fmt: str, *,
                    device=None, mesh=None):
    """The port's ``sparse.Linear`` from a JAX ``InCRSLinearParams``
    (``fmt="incrs"``; a ``stack_init`` stack too, its values with a
    leading stage axis), ``ShardedInCRSLinearParams``
    (``fmt="incrs_sharded"``: the stacked (S, ...) arrays, ``shard_width``
    and ``axes`` among the fields, placed on ``mesh``, a
    ``launch.mesh.Mesh`` of as many shards along those axes),
    ``SparseLinearParams`` (``fmt="bsr"``) or ``DenseLinearParams``
    (``fmt="dense"``).

    ``values`` is ``np.asarray(params.values)``; ``meta_fields`` holds the
    meta's fields (``dataclasses.asdict``-style, tuples as lists, the
    InCRS stripe indices ``fwd_idx``/``bwd_idx``/``t_gather`` as arrays)
    with the pattern given as ``"mask"`` (its element mask, or None) and
    optional ``"version"``, or as ``"pattern"``, the JAX pattern itself
    (``pattern_from_jax``). Both packages then compute the same C and the
    same gradients, and a repack of either gives the same version."""
    from .sparse import api, linear
    from .sparse.pattern import SparsityPattern
    if fmt not in ("incrs", "incrs_sharded", "bsr", "dense"):
        raise ValueError(f"fmt must be 'incrs', 'incrs_sharded', 'bsr' or "
                         f"'dense', got {fmt!r}")
    meta_fields = dict(meta_fields)
    mask = meta_fields.pop("mask", None)
    version = int(meta_fields.pop("version", 0))
    jax_pattern = meta_fields.pop("pattern", None)
    pattern: Optional[SparsityPattern] = None
    if mask is not None:
        pattern = SparsityPattern(np.asarray(mask, bool), version)
    elif jax_pattern is not None:
        pattern = pattern_from_jax(jax_pattern)
    if fmt == "incrs_sharded":
        return _sharded_linear(values, meta_fields, pattern, mesh)
    dev = resolve_device(device)
    vals = torch.from_numpy(np.array(values)).to(dev)
    if fmt == "incrs":
        idx = {f: torch.from_numpy(np.array(meta_fields[f], np.int32)).to(dev)
               for f in ("fwd_idx", "bwd_idx", "t_gather")}
        meta = linear.InCRSLinearMeta(
            idx["fwd_idx"], idx["bwd_idx"], idx["t_gather"],
            *(int(meta_fields[f]) for f in ("d_in", "d_out", "section",
                                             "nnz", "block")),
            pattern=pattern)
        if vals.ndim not in (3, 4) or \
                vals.shape[-3:] != meta.fwd_idx.shape or \
                vals.dtype != torch.float32 or \
                idx["t_gather"].shape != (meta.bwd_idx.numel(),):
            raise ValueError(f"values {tuple(vals.shape)} {vals.dtype} and "
                             f"t_gather {tuple(idx['t_gather'].shape)} do "
                             f"not fit stripes {tuple(meta.fwd_idx.shape)} "
                             f"and {tuple(meta.bwd_idx.shape)}")
        if pattern is not None:
            pattern.packed["incrs"] = meta
        return api.Linear(linear.InCRSLinearParams(vals, meta))
    if fmt == "bsr":
        meta = linear.SparseLinearMeta(
            int(meta_fields["d_in"]), int(meta_fields["d_out"]),
            int(meta_fields["block"]),
            *(tuple(int(x) for x in meta_fields[f])
              for f in _BSR_META_TUPLES), pattern=pattern)
        if vals.shape != (meta.nnz, meta.block, meta.block):
            raise ValueError(f"values {tuple(vals.shape)} do not fit "
                             f"{meta.nnz} blocks of side {meta.block}")
        if pattern is not None:
            pattern.packed["bsr"] = meta
        return api.Linear(linear.SparseLinearParams(vals, meta))
    meta = api.DenseLinearMeta(int(meta_fields["d_in"]),
                               int(meta_fields["d_out"]), pattern=pattern)
    if vals.shape != (meta.d_in, meta.d_out):
        raise ValueError(f"values {tuple(vals.shape)} are not "
                         f"({meta.d_in}, {meta.d_out})")
    return api.Linear(api.DenseLinearParams(vals, meta))


def _sharded_linear(values, meta_fields: Dict[str, Any], pattern, mesh):
    """``linear_from_jax``'s row-sharded InCRS case: shard ``s`` of every
    stacked array goes to ``mesh``'s device of shard ``s``."""
    from .kernels import ops
    from .sparse import api, linear
    if mesh is None:
        raise ValueError("a sharded JAX layer needs mesh=, the port's "
                         "launch.mesh.Mesh to place its shards on")
    axes = tuple(meta_fields["axes"])
    _, n_shards = ops.shard_axes(mesh, axes)
    devs = ops.shard_devices(mesh, axes)
    vals = np.array(values)
    arrs = {f: np.array(meta_fields[f], np.int32)
            for f in ("fwd_idx", "bwd_idx", "t_gather")}
    if vals.shape != arrs["fwd_idx"].shape or vals.dtype != np.float32 \
            or vals.shape[0] != n_shards or \
            arrs["t_gather"].shape != (n_shards,
                                       arrs["bwd_idx"][0].size):
        raise ValueError(f"values {vals.shape} {vals.dtype} and t_gather "
                         f"{arrs['t_gather'].shape} do not fit {n_shards} "
                         f"shards of stripes {arrs['fwd_idx'].shape[1:]} "
                         f"and {arrs['bwd_idx'].shape[1:]}")

    def put(a):
        return tuple(torch.from_numpy(np.ascontiguousarray(a[s])).to(d)
                     for s, d in enumerate(devs))
    meta = linear.ShardedInCRSLinearMeta(
        put(arrs["fwd_idx"]), put(arrs["bwd_idx"]), put(arrs["t_gather"]),
        *(int(meta_fields[f]) for f in ("d_in", "d_out", "section", "nnz")),
        mesh, axes, int(meta_fields["shard_width"]),
        block=int(meta_fields["block"]), pattern=pattern)
    if pattern is not None:
        pattern.packed["incrs_sharded"] = meta
    return api.Linear(linear.ShardedInCRSLinearParams(put(vals), meta))


def adamw_state_from_jax(state: Dict[str, Any], *, device=None
                         ) -> Dict[str, Any]:
    """The port's AdamW state (``train.optimizer``) from a JAX one.

    ``state`` is ``{"m": {name: leaf}, "v": {name: leaf}, "count": c}``
    with numpy leaves keyed by the port's parameter names (the JAX tree
    flattened by the caller): an f32 moment, or ``{"q": int8, "s": f32}``
    when the moments are quantized. The port's next ``adamw_update`` then
    takes the step the JAX one would."""
    dev = resolve_device(device)

    def leaf(x):
        if isinstance(x, dict):
            if set(x) != {"q", "s"}:
                raise ValueError(f"a quantized moment is {{'q', 's'}}, got "
                                 f"{sorted(x)}")
            return {"q": torch.from_numpy(np.array(x["q"], np.int8)).to(dev),
                    "s": torch.from_numpy(np.array(x["s"], np.float32)
                                          ).to(dev)}
        return torch.from_numpy(np.array(x, np.float32)).to(dev)

    if set(state["m"]) != set(state["v"]):
        raise ValueError(f"m and v name different parameters: "
                         f"{sorted(state['m'])} and {sorted(state['v'])}")
    return {"m": {k: leaf(x) for k, x in state["m"].items()},
            "v": {k: leaf(x) for k, x in state["v"].items()},
            "count": torch.tensor(int(np.asarray(state["count"])),
                                  dtype=torch.int32, device=dev)}


def model_from_jax(cfg, params: Dict[str, Any], *, device=None):
    """The port's ``models.model.Model`` computing what the JAX model of
    ``cfg`` computes with ``params``.

    ``params`` is the JAX params tree with numpy leaves: ``embed``,
    ``unembed`` (unless tied), ``norm_final`` and ``groups/block{i}_{kind}``
    holding ``norm_mixer``, ``mixer``, ``norm_mlp`` and ``ffn`` (the last
    two absent where ``mlp_type`` is ``"none"``), each with a leading
    ``n_groups`` axis. ``mixer`` is attention's ``{wq, wk, wv, wo}``, the
    SSD's ``{w_x, w_z, w_bc, w_dt, dt_bias, a_log, d_skip, conv_w, w_out}``
    or the RG-LRU's ``{w_in, w_gate_branch, conv_w, w_rg, w_ig, a_param,
    w_out}``. ``ffn`` is the dense MLP's ``{w_gate, w_up, w_down,
    mask_w_*}`` or the MoE's ``router`` (d, E), ``w_gate``/``w_up`` (E, d,
    f), ``w_down`` (E, f, d) and, with shared experts,
    ``ws_gate``/``ws_up``/``ws_down``. Group ``g``, block ``i`` becomes
    layer ``g * len(cfg.block_pattern) + i``; a leaf keeps its name
    (``mixer/a_log`` -> ``blocks.<layer>.mixer.a_log``)."""
    from .models.model import Model
    model = Model(cfg, device=resolve_device(device))
    state = {"embed": params["embed"], "norm_final": params["norm_final"]}
    if not cfg.tie_embeddings:
        state["unembed"] = params["unembed"]
    period = len(cfg.block_pattern)
    for i, kind in enumerate(cfg.block_pattern):
        blk = params["groups"][f"block{i}_{kind}"]
        for g in range(cfg.n_groups):
            pre = f"blocks.{g * period + i}."
            for name, leaf in blk.items():
                if isinstance(leaf, dict):
                    for sub, arr in leaf.items():
                        state[f"{pre}{name}.{sub}"] = arr[g]
                else:
                    state[f"{pre}{name}"] = leaf[g]
    own = model.state_dict()
    if set(state) != set(own):
        raise ValueError(f"params do not match {cfg.name}: missing "
                         f"{sorted(set(own) - set(state))}, unexpected "
                         f"{sorted(set(state) - set(own))}")
    # load_state_dict copies each array into place in the parameter dtype
    model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in state.items()})
    return model
