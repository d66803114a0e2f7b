"""Public kernel API: format preparation and ``spmm``.

The port of ``repro.kernels.ops``, all but its deprecated shims.
``prep_sections``
turns an InCRS operand into the padded per-(row, section) stripes the
kernels consume, located through the packed counter words alone;
``prepare_incrs`` memoizes that per live operand, or per pattern version
(``prepare_versioned``: a repack's version bump, or a rebuilt source
object, misses); ``spmm`` pads B, picks
the column tile and the grid order (``auto``: the autotuner's entry for
this exact shape and backend, else its cost model's pick), and trims the
result. ``prepare_incrs_sharded`` splits the stripes into per-device row
panels over a ``launch.mesh.Mesh`` and ``spmm(..., mesh=)`` runs one
launch a shard.
``prep_rounds`` turns a CRS operand into padded per-round rows, and
``spmm(CRS, CRS | InCRS)`` runs sparse × sparse C = A @ B.T through one of
three engines: the fused index-matching kernel (paper Alg. 2),
condense + merge (``repro_torch.spgemm``), or densify B then the fused
InCRS SpMM. ``bsr_kernel_meta``/``prep_bsr`` turn a BSR operand into the
block lists of the BSR kernel, and ``spmm(BSR, B)`` runs it;
``dense_mm`` and ``spmm(dense 2-D, B)`` run the tiled dense kernel. Both
kernels mask their ragged edges, so neither pads A or B. ``flash_mha``
runs causal grouped-query attention through the flash kernel.

Entry points take ``device=`` and default to ``"cuda"``: without CUDA they
raise unless the caller asks for ``"cpu"``, where the kernels' plain torch
versions run.
"""
from __future__ import annotations

import dataclasses
import warnings
import weakref
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.bsr import BSR
from ..core.crs import CRS
from ..core.incrs import InCRS
from . import bsr_spmm as _bsr_k
from . import incrs_spmm as _k
from .dense_mm import dense_mm as _dense_mm_kernel
from .flash_attention import flash_attention as _flash_kernel
from .incrs_gather import incrs_gather as _incrs_gather_kernel
from .index_match_spmm import index_match_spmm as _index_match_kernel

VARIANTS = ("auto", "expand", "reuse", "pipelined")

_INCRS_KERNELS = {"expand": _k.incrs_spmm,
                  "reuse": _k.incrs_spmm_reuse,
                  "pipelined": _k.incrs_spmm_pipelined}


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means CUDA. Asking for CUDA
    where there is none raises instead of running on the CPU. A CUDA
    device without an index gets the current one, so it compares equal
    to the device of the tensors made on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; the port runs on the GPU unless the "
                "caller passes device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be 'auto', 'expand', 'reuse' or "
                         f"'pipelined', got {variant!r}")


# ----------------------------------------------------------------------
def dense_mm(a, b, *, device=None) -> torch.Tensor:
    """C = A @ B through the tiled dense kernel, f32 sums, C in
    ``a.dtype``. The JAX version pads every dimension up to its tile and
    trims; the kernel here masks its edges, so nothing is padded. A CUDA
    tensor A stays where it is when ``device`` is None; otherwise both go
    to ``device`` (default CUDA)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    dev = a.device if device is None and a.device.type == "cuda" \
        else resolve_device(device)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dims disagree: A is {tuple(a.shape)}, "
                         f"B is {tuple(b.shape)}")
    return _dense_mm_kernel(a.to(dev).contiguous(), b.to(dev).contiguous())


# ----------------------------------------------------------------------
def bsr_kernel_meta(bsr: BSR
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """BSR -> kernel block lists ``(row_of + sentinel, col_of, vpos)``.

    Empty block-rows get one explicit zero tile (stably sorted into place)
    so every output block-row is written, and the trailing ``row_of``
    sentinel is well-defined even for an all-empty matrix. ``vpos[q]`` is
    the slot of real block ``q`` inside the padded sequence (pad slots
    expect zero values).
    """
    deg = np.diff(bsr.row_ptr)
    row_of = np.repeat(np.arange(bsr.n_block_rows, dtype=np.int32),
                       deg.astype(np.int64))
    col_of = bsr.col_idx.astype(np.int32)
    vpos = np.arange(len(col_of), dtype=np.int32)
    empty = np.nonzero(deg == 0)[0].astype(np.int32)
    if empty.size:
        row_all = np.concatenate([row_of, empty])
        col_all = np.concatenate([col_of, np.zeros_like(empty)])
        order = np.argsort(row_all, kind="stable")
        inv = np.empty(order.size, np.int64)
        inv[order] = np.arange(order.size)
        vpos = inv[:len(col_of)].astype(np.int32)
        row_of, col_of = row_all[order], col_all[order]
    row_of = np.concatenate([row_of, row_of[-1:]])       # sentinel
    return row_of.astype(np.int32), col_of, vpos


def prep_bsr(bsr: BSR, *, device=None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
    """BSR -> (row_of, col_of, values, row_start) tensors on ``device`` for
    the kernel, with zero tiles in place for empty block-rows (see
    ``bsr_kernel_meta``). The first three are the JAX prep's;
    ``row_start`` (the block-row prefix counters, one past each run) is
    derived here once so a launch derives nothing."""
    dev = resolve_device(device)
    row_of, col_of, vpos = bsr_kernel_meta(bsr)
    values = bsr.values
    if len(col_of) != len(values):
        padded = np.zeros((len(col_of),) + bsr.block, values.dtype)
        padded[vpos] = values
        values = padded
    row_start = _bsr_k.block_row_starts(row_of[:-1], bsr.n_block_rows)
    return (torch.from_numpy(row_of).to(dev),
            torch.from_numpy(col_of).to(dev),
            torch.from_numpy(np.ascontiguousarray(values)).to(dev),
            torch.from_numpy(row_start).to(dev))


def _spmm_bsr(bsr: BSR, b, *, device=None) -> torch.Tensor:
    """C = BSR(A) @ B through the prefix-counter-steered BSR kernel, prepped
    on this call (a plan preps once: ``sparse.plan_for_operand``). C has
    ``b.dtype``."""
    b = torch.as_tensor(b)
    if b.ndim != 2 or b.shape[0] != bsr.shape[1]:
        raise ValueError(f"inner dims disagree: A is {bsr.shape}, "
                         f"B is {tuple(b.shape)}")
    row_of, col_of, values, row_start = prep_bsr(bsr, device=device)
    return bsr_matmul_arrays(row_of, col_of, values,
                             b.to(row_of.device).contiguous(),
                             n_block_rows=bsr.n_block_rows,
                             row_start=row_start)


def bsr_matmul_arrays(row_of, col_of, values, b, *, n_block_rows: int,
                      row_start: torch.Tensor) -> torch.Tensor:
    """The BSR kernel from already prepared block lists: the entry point
    of the BSR sparse linear layer and of bound ``bsr`` plans, which pass
    the device ``row_start`` they built once."""
    return _bsr_k.bsr_spmm(row_of, col_of, values, b,
                           n_block_rows=n_block_rows, row_start=row_start)


# ----------------------------------------------------------------------
def _prep_sections_np(incrs: InCRS, pad_rows_to: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    m, _ = incrs.shape
    crs = incrs.crs
    n_sections = incrs.n_sections
    prefix, blocks = incrs.counters_unpacked()
    cnt = blocks.sum(axis=-1)                          # (m, n_sections)
    starts = crs.row_ptr[:m, None] + prefix            # (m, n_sections)
    smax = max(1, int(cnt.max(initial=0)))
    mp = -(-m // pad_rows_to) * pad_rows_to
    idx = np.full((mp, n_sections, smax), -1, dtype=np.int32)
    val = np.zeros((mp, n_sections, smax), dtype=np.float32)
    total = int(cnt.sum())
    if total:
        flat_cnt = cnt.reshape(-1)
        # slot inside its (row, section) span: global position minus the
        # span's exclusive prefix sum.
        off = np.concatenate([[0], np.cumsum(flat_cnt)[:-1]])
        slot = np.arange(total, dtype=np.int64) - np.repeat(off, flat_cnt)
        src = np.repeat(starts.reshape(-1), flat_cnt) + slot
        grid_i, grid_s = np.indices((m, n_sections))
        rows = np.repeat(grid_i.reshape(-1), flat_cnt)
        secs = np.repeat(grid_s.reshape(-1), flat_cnt)
        idx[rows, secs, slot] = crs.col_idx[src] - secs * incrs.section
        val[rows, secs, slot] = crs.values[src]
    return idx, val


def prep_sections(incrs: InCRS, pad_rows_to: int = 8, *, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """InCRS -> padded per-(row, section) ``(idx, val)`` on ``device``,
    using ONLY the packed counter words for location: the prefix gives a
    section's start inside its row, the block counts its length."""
    dev = resolve_device(device)
    idx, val = _prep_sections_np(incrs, pad_rows_to)
    return torch.from_numpy(idx).to(dev), torch.from_numpy(val).to(dev)


# eq=False: identity semantics for a cached device artifact.
@dataclasses.dataclass(frozen=True, eq=False)
class PreparedOperand:
    """Device-ready section-stripe form of one InCRS operand: prep runs
    once and every SpMM against the operand reuses the tensors."""
    idx: torch.Tensor             # (Mp, n_sections, smax) int32, -1 = pad
    val: torch.Tensor             # (Mp, n_sections, smax) f32
    shape: Tuple[int, int]        # original (M, K) of the sparse operand
    section: int

    @property
    def n_sections(self) -> int:
        return self.idx.shape[1]

    @property
    def padded_rows(self) -> int:
        return self.idx.shape[0]

    @property
    def device(self) -> torch.device:
        return self.idx.device


# id() can be recycled after an object dies: each entry carries a weakref
# that must still point at the SAME object to count as a hit.
_PREP_CACHE: Dict[Tuple, Tuple[weakref.ref, PreparedOperand]] = {}
_PREP_CACHE_MAX = 64


def prepare_incrs(incrs: InCRS, *, pad_rows_to: int = 128, pattern=None,
                  device=None) -> PreparedOperand:
    """Prep an InCRS operand for the fused SpMM, memoized per live operand
    and device (LRU, at most ``_PREP_CACHE_MAX`` entries). The operand is
    treated as immutable once prepped: after mutating ``incrs.crs`` in
    place, call ``invalidate_prepared``.

    ``pattern`` (a ``sparse.SparsityPattern``) keys the memo on the
    pattern lineage instead, guarded by its version AND this InCRS
    object's identity (``prepare_versioned``)."""
    dev = resolve_device(device)
    if pattern is not None:
        return prepare_versioned(
            pattern,
            f"incrs/{incrs.section}/{incrs.block}/{pad_rows_to}/{dev}",
            lambda: PreparedOperand(
                *prep_sections(incrs, pad_rows_to=pad_rows_to, device=dev),
                incrs.shape, incrs.section),
            token=incrs)
    key = (id(incrs), incrs.section, incrs.block, pad_rows_to, str(dev))
    hit = _PREP_CACHE.get(key)
    if hit is not None and hit[0]() is incrs:
        _PREP_CACHE[key] = _PREP_CACHE.pop(key)       # most recently used
        return hit[1]
    idx, val = prep_sections(incrs, pad_rows_to=pad_rows_to, device=dev)
    prep = PreparedOperand(idx, val, incrs.shape, incrs.section)
    if len(_PREP_CACHE) >= _PREP_CACHE_MAX:
        _PREP_CACHE.pop(next(iter(_PREP_CACHE)))      # least recently used
    _PREP_CACHE[key] = (weakref.ref(incrs), prep)
    # Drop the entry (and its device tensors) the moment the operand dies.
    weakref.finalize(incrs, _PREP_CACHE.pop, key, None)
    return prep


def invalidate_prepared(incrs: InCRS) -> None:
    """Evict every cached ``PreparedOperand`` of ``incrs``."""
    for k in [k for k in _PREP_CACHE if k[0] == id(incrs)]:
        _PREP_CACHE.pop(k, None)


# Pattern-version-keyed prep: entries belong to a sparsity-pattern lineage
# (any object with ``uid`` and ``version``), keyed ``(uid, flavor)``; the
# flavor names what was built and on which device. A repack bumps the
# version, so the next lookup rebuilds. An optional ``token`` (the source
# object) also guards identity: values change WITHOUT a version bump while
# training on a fixed pattern, so a rebuilt source must miss.
_VERSIONED_CACHE: Dict[Tuple[int, str], Tuple[int, object, object]] = {}
_VERSIONED_CACHE_MAX = 32


def prepare_versioned(pattern, flavor: str, build, token=None):
    """Memoize ``build()`` under ``(pattern.uid, flavor)``, guarded by
    ``pattern.version`` and (when given) the identity of the live object
    ``token``: a version mismatch or a different or dead token rebuilds
    and replaces the entry. LRU, at most ``_VERSIONED_CACHE_MAX``
    entries."""
    key = (pattern.uid, str(flavor))
    hit = _VERSIONED_CACHE.get(key)
    if hit is not None and hit[0] == pattern.version and \
            (hit[1] is None or hit[1]() is token):
        _VERSIONED_CACHE[key] = _VERSIONED_CACHE.pop(key)   # LRU promote
        return hit[2]
    prep = build()
    _VERSIONED_CACHE.pop(key, None)
    if len(_VERSIONED_CACHE) >= _VERSIONED_CACHE_MAX:
        _VERSIONED_CACHE.pop(next(iter(_VERSIONED_CACHE)))
    _VERSIONED_CACHE[key] = (
        pattern.version, weakref.ref(token) if token is not None else None,
        prep)
    return prep


def invalidate_pattern(pattern) -> None:
    """Drop every versioned prep entry of ``pattern``'s lineage."""
    for k in [k for k in _VERSIONED_CACHE if k[0] == pattern.uid]:
        _VERSIONED_CACHE.pop(k, None)


# ----------------------------------------------------------------------
def default_bn(n: int) -> int:
    """Fewest ~512-wide col tiles, then the 128-multiple that just covers
    them: padding waste stays under 128 cols per tile."""
    np128 = -(-n // 128) * 128
    tiles = -(-np128 // 512)
    return -(-np128 // (tiles * 128)) * 128


def resolve_incrs(prep: PreparedOperand, n: int, *, bm: int = 128,
                  bn: Optional[int] = None, variant: str = "auto",
                  tuned=None) -> Tuple[str, int, Optional[tuple]]:
    """What ``spmm`` launches for ``prep`` times an N-column B: ``(variant,
    bn, geometry)``. ``auto`` rides ``tuned`` (a plan's
    ``autotune.TunedConfig``) or else the autotuner's entry for this exact
    shape and backend, where ``bn`` is not pinned: its order and column
    tile, and its launch geometry where it was measured at this N. Without
    either it takes ``autotune.model_pick_variant``'s order at the
    wrapper's own geometry (None). An explicit variant runs the wrapper's
    own geometry."""
    from . import autotune                      # circular at module scope
    check_variant(variant)
    geometry = None
    if variant == "auto" and bn is None:
        if tuned is None:
            tuned = autotune.lookup(autotune.cache_key(
                prep.padded_rows, prep.n_sections, prep.idx.shape[2],
                prep.section, n, autotune.backend_name(prep.device)))
        if tuned is not None:
            variant, bn = tuned.variant, tuned.bn
            if tuned.n_cols == n:
                geometry = tuned.launch_geometry
    if bn is None:
        bn = default_bn(n)
    if variant == "auto":
        variant = autotune.model_pick_variant(
            _k._resolve_row_tile(prep.padded_rows, bm)[1], -(-n // bn) * bn,
            n_sections=prep.n_sections, smax=prep.idx.shape[2],
            section=prep.section)
    return variant, bn, geometry


def _spmm_incrs(a, b, *, bm: int = 128, bn: Optional[int] = None,
                variant: str = "auto", device=None,
                tuned=None) -> torch.Tensor:
    """C = A @ B through the fused InCRS kernel of the chosen grid order.
    ``a`` is an InCRS (prepped through the memo on ``device``) or a
    ``PreparedOperand`` (B is moved to its device). ``variant="auto"``
    launches what ``resolve_incrs`` picks: the tuned launch, else the
    cost model's order. Returns f32 C[:M, :N]."""
    check_variant(variant)
    if isinstance(a, PreparedOperand):
        prep = a
        if device is not None and resolve_device(device) != prep.device:
            raise ValueError(f"operand lives on {prep.device}, device="
                             f"{device!r} asks for another")
    else:
        prep = prepare_incrs(a, pad_rows_to=bm, device=device)
    b = torch.as_tensor(b)
    if b.ndim != 2:
        raise ValueError(f"B must be 2-D, got shape {tuple(b.shape)}")
    b = b.to(prep.device)
    m, k = prep.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims disagree: A is {prep.shape}, "
                         f"B is {tuple(b.shape)}")
    variant, bn, geometry = resolve_incrs(prep, n, bm=bm, bn=bn,
                                          variant=variant, tuned=tuned)
    kp = prep.n_sections * prep.section
    np_ = -(-n // bn) * bn
    # pad copies, but leaves a strided B strided when it pads nothing
    b = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k)).contiguous()
    out = _INCRS_KERNELS[variant](prep.idx, prep.val, b,
                                  section=prep.section, bm=bm, bn=bn,
                                  geometry=geometry)
    return out[:m, :n]


# ----------------------------------------------------------------------
# Row-sharded prep: the paper's mesh scales by giving each comparator-mesh
# row its OWN slice of the sparse operand while the dense operand is shared
# across the mesh (§IV). Each shard owns one contiguous output-row panel of
# the section stripes, on its own device of a ``launch.mesh.Mesh``; the
# dense RHS is copied once to each distinct device, and the per-shard
# output panels concatenate along rows. One process drives every device.
def shard_axes(mesh, axis) -> Tuple[Tuple[str, ...], int]:
    """Normalize the shard-axis spec and count the shards it yields:
    ``axis=None`` -> every mesh axis (one shard per device), a name or
    tuple of names otherwise. Returns ``(axes, n_shards)``; the sharded
    packer in ``sparse.linear`` uses it too, so the two always agree."""
    if axis is None:
        axes = tuple(mesh.axis_names)
    else:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
    sizes = mesh.shape
    unknown = [a for a in axes if a not in sizes]
    if unknown:
        raise ValueError(f"mesh axes {tuple(mesh.axis_names)} have no "
                         f"{unknown}")
    n_shards = 1
    for a in axes:
        n_shards *= sizes[a]
    return axes, n_shards


def shard_devices(mesh, axes: Tuple[str, ...]) -> Tuple[torch.device, ...]:
    """The device of each shard: the mesh's devices with ``axes`` first (in
    that order, shard index row-major over them), at index 0 of every
    other axis. A shard lives once, not replicated over the axes it is
    not split over."""
    order = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(mesh.devices.ndim) if i not in order]
    devs = np.transpose(mesh.devices, order + rest)
    devs = devs[(Ellipsis,) + (0,) * len(rest)] if rest else devs
    return tuple(resolve_device(d) for d in devs.ravel())


# eq=False: identity semantics for a cached device artifact.
@dataclasses.dataclass(frozen=True, eq=False)
class ShardedPreparedOperand:
    """Row-sharded section-stripe form of one InCRS operand: shard ``s``
    holds global output rows ``[s * rows_per_shard, (s + 1) *
    rows_per_shard)`` (the tail shard may be partly empty) as its own
    stripe panel ``idx[s]``/``val[s]`` on its own device, so no device
    holds another shard's stripes. Every panel has the same shape (the
    slot width is the densest shard's)."""
    idx: Tuple[torch.Tensor, ...]  # per shard (Rp, n_sections, smax) int32
    val: Tuple[torch.Tensor, ...]  # per shard (Rp, n_sections, smax) f32
    shape: Tuple[int, int]         # global (M, K) of the sparse operand
    section: int
    rows_per_shard: int            # real output rows owned by each shard
    mesh: Any
    axes: Tuple[str, ...]          # mesh axes the shard dim is split over

    @property
    def n_shards(self) -> int:
        return len(self.idx)

    @property
    def n_sections(self) -> int:
        return self.idx[0].shape[1]

    @property
    def padded_rows(self) -> int:
        return self.idx[0].shape[0]

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(t.device for t in self.idx)

    @property
    def device(self) -> torch.device:
        """The first shard's device, where ``spmm`` gathers C."""
        return self.idx[0].device

    def shard(self, s: int) -> PreparedOperand:
        """Shard ``s`` as a single-device operand of ``rows_per_shard``
        rows: what its launch sees."""
        return PreparedOperand(self.idx[s], self.val[s],
                               (self.rows_per_shard, self.shape[1]),
                               self.section)

    def row_range(self, s: int) -> Tuple[int, int]:
        """The global output rows ``[lo, hi)`` shard ``s`` really holds."""
        lo = min(self.shape[0], s * self.rows_per_shard)
        return lo, min(self.shape[0], lo + self.rows_per_shard)


def _stack_shards(gi: np.ndarray, gv: np.ndarray, n_shards: int,
                  pad_rows_to: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Split unpadded (m, Si, smax) stripes into ``n_shards`` contiguous
    row panels of ``ceil(m / n_shards)`` rows, each padded to a multiple
    of ``pad_rows_to`` (-1 / 0.0): the (S, Rp, Si, smax) arrays of JAX's
    sharded prep, and the rows a shard owns."""
    m, si, smax = gi.shape
    rows_per_shard = -(-m // n_shards)
    rp = -(-rows_per_shard // pad_rows_to) * pad_rows_to
    idx = np.full((n_shards, rp, si, smax), -1, dtype=np.int32)
    val = np.zeros((n_shards, rp, si, smax), dtype=np.float32)
    for s in range(n_shards):
        lo = s * rows_per_shard
        hi = min(m, lo + rows_per_shard)
        if hi > lo:
            idx[s, :hi - lo] = gi[lo:hi]
            val[s, :hi - lo] = gv[lo:hi]
    return idx, val, rows_per_shard


def prepare_incrs_sharded(incrs: InCRS, mesh, *, axis=None,
                          pad_rows_to: int = 128,
                          pattern=None) -> ShardedPreparedOperand:
    """Partition an InCRS operand into per-device output-row stripe shards.

    The section stripes are built once on the host (``prep_sections``'s
    arithmetic, so each row's content is the single-device prep's), split
    into ``n_shards`` contiguous row ranges, and each panel is moved to its
    own device of ``mesh`` (``shard_devices``). ``axis`` (default: every
    mesh axis) names the mesh axes the shard dimension is split over.
    ``pattern`` memoizes the shard prep on the pattern lineage,
    invalidated by repack version bumps (``prepare_versioned``)."""
    if pattern is not None:
        axes_n, _ = shard_axes(mesh, axis)
        return prepare_versioned(
            pattern,
            f"incrs_sharded/{id(mesh)}/{axes_n}/{incrs.section}/"
            f"{incrs.block}/{pad_rows_to}",
            lambda: prepare_incrs_sharded(incrs, mesh, axis=axis,
                                          pad_rows_to=pad_rows_to),
            token=incrs)
    axes, n_shards = shard_axes(mesh, axis)
    devs = shard_devices(mesh, axes)
    gi, gv = _prep_sections_np(incrs, 1)
    idx, val, rows_per_shard = _stack_shards(gi, gv, n_shards, pad_rows_to)
    return ShardedPreparedOperand(
        tuple(torch.from_numpy(idx[s]).to(d) for s, d in enumerate(devs)),
        tuple(torch.from_numpy(val[s]).to(d) for s, d in enumerate(devs)),
        incrs.shape, incrs.section, rows_per_shard, mesh, axes)


def _padded_rhs(b: torch.Tensor, kp: int, np_: int) -> torch.Tensor:
    """B zero-padded to (kp, np_), contiguous."""
    return torch.nn.functional.pad(
        b, (0, np_ - b.shape[1], 0, kp - b.shape[0])).contiguous()


def sharded_panels(prep: ShardedPreparedOperand, bs, *, bm: int = 128,
                   bn: Optional[int] = None, variant: str = "auto",
                   tuned=None) -> list:
    """Each shard's rows of C = A @ B, on its own device: one launch a
    shard of the order ``resolve_incrs`` picks for the per-shard panel
    (every panel has one shape, so one pick serves all). ``bs`` maps each
    distinct device of the shards to B there (the caller copies B once a
    device). Shard ``s``'s entry holds global rows ``prep.row_range(s)``
    and N columns, f32. Launches on different cards go on each device's
    current stream; nothing here waits for the host. ``bm`` clamps to the
    shard-local panel inside the wrappers."""
    check_variant(variant)
    m, k = prep.shape
    b0 = next(iter(bs.values()))
    if b0.ndim != 2 or b0.shape[0] != k:
        raise ValueError(f"inner dims disagree: A is {prep.shape}, "
                         f"B is {tuple(b0.shape)}")
    n = b0.shape[1]
    variant, bn, geometry = resolve_incrs(prep.shard(0), n, bm=bm, bn=bn,
                                          variant=variant, tuned=tuned)
    kp = prep.n_sections * prep.section
    np_ = -(-n // bn) * bn
    padded = {d: _padded_rhs(b, kp, np_) for d, b in bs.items()}
    out = []
    for s in range(prep.n_shards):
        lo, hi = prep.row_range(s)
        c = _INCRS_KERNELS[variant](prep.idx[s], prep.val[s],
                                    padded[prep.idx[s].device],
                                    section=prep.section, bm=bm, bn=bn,
                                    geometry=geometry)
        out.append(c[:hi - lo, :n])
    return out


def _spmm_incrs_sharded(a, b, *, mesh=None, axis=None, bm: int = 128,
                        bn: Optional[int] = None, variant: str = "auto",
                        tuned=None) -> torch.Tensor:
    """C = A @ B with A row-sharded across the mesh: B is copied once to
    each distinct device of the shards, each shard's panel runs its own
    launch (``sharded_panels``), and the panels are concatenated along
    rows on the first shard's device. A is never gathered onto one device.
    Per-row arithmetic is the single-device kernel's, so each shard's
    rows are bitwise equal to the single-device rows at equal order and
    geometry."""
    if isinstance(a, ShardedPreparedOperand):
        prep = a
    else:
        if mesh is None:
            raise ValueError("row-sharded spmm needs mesh= when given a "
                             "raw InCRS (or pass a ShardedPreparedOperand)")
        prep = prepare_incrs_sharded(a, mesh, axis=axis)
    b = torch.as_tensor(b)
    if b.ndim != 2:
        raise ValueError(f"B must be 2-D, got shape {tuple(b.shape)}")
    bs = {d: b.to(d) for d in dict.fromkeys(prep.devices)}
    panels = sharded_panels(prep, bs, bm=bm, bn=bn, variant=variant,
                            tuned=tuned)
    home = prep.device
    return torch.cat([p.to(home) for p in panels])


def incrs_to_dense(incrs: InCRS, *, bm: int = 8,
                   device=None) -> torch.Tensor:
    """Densify an InCRS matrix on ``device`` through the gather kernel: f32
    (M, K). Prep is memoized per live operand (see ``prepare_incrs``)."""
    prep = prepare_incrs(incrs, pad_rows_to=bm, device=device)
    out = _incrs_gather_kernel(prep.idx, prep.val, section=incrs.section,
                               bm=bm)
    return out[:incrs.shape[0], :incrs.shape[1]]


# ----------------------------------------------------------------------
def round_groups(crs: CRS, rounds: int) -> Tuple[np.ndarray, np.ndarray]:
    """The (row, round window) group ``row * n_rounds + col // rounds`` of
    every non-zero, int64 (nnz,), and the non-zeros in each group, int64
    (M, n_rounds)."""
    m, k = crs.shape
    n_rounds = max(1, -(-k // rounds))
    row_of = np.repeat(np.arange(m), np.diff(crs.row_ptr).astype(np.int64))
    g = row_of * n_rounds + crs.col_idx.astype(np.int64) // rounds
    return g, np.bincount(g, minlength=m * n_rounds).reshape(m, n_rounds)


def _prep_rounds_np(crs: CRS, rounds: int, rmax: Optional[int],
                    pad_rows_to: int, on_overflow: str
                    ) -> Tuple[np.ndarray, np.ndarray]:
    if on_overflow not in ("raise", "drop"):
        raise ValueError(f"on_overflow must be 'raise' or 'drop', "
                         f"got {on_overflow!r}")
    g, counts = round_groups(crs, rounds)
    m, n_rounds = counts.shape
    rmax_true = int(counts.max(initial=1))
    rmax = rmax_true if rmax is None else rmax
    rmax = max(1, min(rmax, rounds))
    if rmax < rmax_true:
        if on_overflow == "raise":
            raise ValueError(
                f"rmax={rmax} cannot hold the densest (row, round) window "
                f"({rmax_true} non-zeros); raise rmax or pass "
                f"on_overflow='drop'")
        warnings.warn(
            f"prep_rounds: dropping non-zeros beyond slot {rmax} in "
            f"{int((counts > rmax).sum())} overfull (row, round) windows "
            f"(densest holds {rmax_true})", stacklevel=3)
    mp = -(-m // pad_rows_to) * pad_rows_to
    idx = np.full((mp, n_rounds, rmax), -1, dtype=np.int32)
    val = np.zeros((mp, n_rounds, rmax), dtype=crs.values.dtype)
    if crs.nnz:
        # Non-zeros are sorted by (row, col), hence by (row, round): each
        # group is one contiguous run, and a slot is the position in it.
        group_start = np.concatenate(
            [[0], np.cumsum(counts.reshape(-1))[:-1]])
        slot = np.arange(crs.nnz, dtype=np.int64) - group_start[g]
        sel = slot < rmax
        row_of, r = np.divmod(g[sel], n_rounds)
        idx[row_of, r, slot[sel]] = crs.col_idx[sel] % rounds
        val[row_of, r, slot[sel]] = crs.values[sel]
    return idx, val


def prep_rounds(crs: CRS, rounds: int, rmax: Optional[int] = None,
                pad_rows_to: int = 128, on_overflow: str = "raise",
                dtype: torch.dtype = torch.float32, *, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CRS -> padded per-round ``(idx, val)`` on ``device``; idx local in
    [0, R), -1 = pad, shape (Mp, n_rounds, rmax).

    Rows are padded up to a multiple of ``pad_rows_to``; at most R
    non-zeros fit in one round window, so rmax <= R. ``dtype`` sets the
    value tensor's type. A caller-supplied ``rmax`` below
    the densest (row, round) count raises with ``on_overflow="raise"``;
    ``on_overflow="drop"`` keeps the first ``rmax`` non-zeros of each
    window and warns about the rest.
    """
    dev = resolve_device(device)
    idx, val = _prep_rounds_np(crs, rounds, rmax, pad_rows_to, on_overflow)
    return (torch.from_numpy(idx).to(dev),
            torch.from_numpy(val).to(dtype).to(dev))


def _pad_rmax(idx: torch.Tensor, val: torch.Tensor,
              rmax: int) -> Tuple[torch.Tensor, torch.Tensor]:
    extra = rmax - idx.shape[2]
    if extra == 0:
        return idx, val
    return (torch.nn.functional.pad(idx, (0, extra), value=-1),
            torch.nn.functional.pad(val, (0, extra)))


def pad_common_rmax(ai, av, bi, bv):
    """Pad both operands' slot axis to the larger rmax (-1 / 0 slots)."""
    rmax = max(ai.shape[2], bi.shape[2])
    return (*_pad_rmax(ai, av, rmax), *_pad_rmax(bi, bv, rmax))


def index_match_prepped(ai, av, bi, bv, *, rounds: int = 128,
                        bm: int = 128, bn: int = 128,
                        out_dtype: Optional[torch.dtype] = None,
                        geometry=None) -> torch.Tensor:
    """Round-synchronized index-matching SpMM from PRE-PREPPED per-round
    operands (``prep_rounds`` output): pads both sides to a common rmax
    and runs the kernel (at ``geometry`` where given: a tuned launch).
    Returns the PADDED output; callers trim to the real (M, N). C takes
    ``out_dtype``, by default the promoted type of the two value
    tensors."""
    if out_dtype is None:
        out_dtype = torch.promote_types(av.dtype, bv.dtype)
    ai, av, bi, bv = pad_common_rmax(ai, av, bi, bv)
    return _index_match_kernel(ai, av, bi, bv, rounds=rounds, bm=bm, bn=bn,
                               out_dtype=out_dtype, geometry=geometry)


def _resolve_matched_tiles(m: int, n: int, k: int, rounds, bm, bn, device
                           ) -> Tuple[int, int, int, Optional[tuple]]:
    """Fill ``None`` (rounds, bm, bn) from the autotuner's matched entry
    for this (m, n, k) and backend (``autotune.tune_index_match``), else
    with 128. Returns them and the tuned geometry, which index matching
    launches where every one of the three came from the entry."""
    from . import autotune                      # circular at module scope
    geometry = None
    if rounds is None or bm is None or bn is None:
        tuned = autotune.lookup(autotune.matched_cache_key(
            m, n, k, autotune.backend_name(resolve_device(device))))
        if tuned is not None:
            if rounds is None and bm is None and bn is None:
                geometry = tuned.launch_geometry
            rounds = (tuned.rounds or 128) if rounds is None else rounds
            bm = tuned.bm if bm is None else bm
            bn = tuned.bn if bn is None else bn
    return (128 if rounds is None else rounds,
            128 if bm is None else bm,
            128 if bn is None else bn, geometry)


def check_inner(a: CRS, bt: CRS) -> None:
    if a.shape[1] != bt.shape[1]:
        raise ValueError(f"inner dims disagree: A is {a.shape}, "
                         f"Bt is {bt.shape} (expected equal col counts)")


def _spmm_index_match(a: CRS, bt: CRS, *, rounds: Optional[int] = None,
                      bm: Optional[int] = None, bn: Optional[int] = None,
                      device=None) -> torch.Tensor:
    """C = A @ Bt.T through the fused index-matching kernel (paper Alg. 2).
    Returns C[:M, :N] unpadded."""
    check_inner(a, bt)
    rounds, bm, bn, geometry = _resolve_matched_tiles(
        a.shape[0], bt.shape[0], a.shape[1], rounds, bm, bn, device)
    ai, av = prep_rounds(a, rounds, pad_rows_to=bm, device=device)
    bi, bv = prep_rounds(bt, rounds, pad_rows_to=bn, device=device)
    out = index_match_prepped(ai, av, bi, bv, rounds=rounds, bm=bm, bn=bn,
                              geometry=geometry)
    return out[:a.shape[0], :bt.shape[0]]


def _incrs_of(crs: CRS) -> InCRS:
    """InCRS view of a CRS operand, memoized per live operand, so the
    densify engine does not re-pack counters (or re-prep, through
    ``prepare_incrs``) on every call. The CRS is treated as immutable once
    converted. The memo lives on the operand: an InCRS holds its CRS, so a
    module-level table of them would keep every operand alive."""
    incrs = vars(crs).get("_incrs")
    if incrs is None:
        incrs = crs._incrs = InCRS.from_crs(crs)
    return incrs


_SPGEMM_VARIANTS = ("auto", "condense_merge", "densify", "reference")


def _spmm_spgemm(a: CRS, b, *, rounds: Optional[int] = None,
                 bm: Optional[int] = None, bn: Optional[int] = None,
                 variant: str = "auto", device=None) -> torch.Tensor:
    """C = A @ Bt.T for sparse A and sparse Bt (CRS or InCRS): the SpGEMM
    dispatch. Engines:

      * ``"reference"``      — the fused index-matching kernel, one launch;
      * ``"condense_merge"`` — per-round stripes, then their merge
        (``spgemm.condense_merge_prepped``), bitwise equal to reference;
      * ``"densify"``        — gather Bt dense on the device, then the
        fused InCRS SpMM;
      * ``"auto"``           — the engine of least predicted time on the
        card: ``core.mesh_sim.spgemm_cost_for`` priced by
        ``autotune.pick_spgemm_engine``.
    """
    if variant not in _SPGEMM_VARIANTS:
        raise ValueError(f"variant must be one of {_SPGEMM_VARIANTS}, "
                         f"got {variant!r}")
    bt = b.crs if isinstance(b, InCRS) else b
    check_inner(a, bt)
    m, n = a.shape[0], bt.shape[0]
    if variant == "auto":
        from ..core import mesh_sim
        from . import autotune                  # circular at module scope
        tuned_rounds = _resolve_matched_tiles(m, n, a.shape[1], rounds, bm,
                                              bn, device)[0]
        variant = autotune.pick_spgemm_engine(
            mesh_sim.spgemm_cost_for(a, bt, rounds=tuned_rounds))
    if variant == "reference":
        return _spmm_index_match(a, bt, rounds=rounds, bm=bm, bn=bn,
                                 device=device)
    rounds, bm, bn, _ = _resolve_matched_tiles(m, n, a.shape[1], rounds, bm,
                                               bn, device)
    if variant == "densify":
        dense_b = incrs_to_dense(_incrs_of(bt), device=device).T
        return _spmm_incrs(_incrs_of(a), dense_b, device=device)
    from .. import spgemm as _spgemm            # circular at module scope
    ai, av = prep_rounds(a, rounds, pad_rows_to=bm, device=device)
    bi, bv = prep_rounds(bt, rounds, pad_rows_to=bn, device=device)
    out = _spgemm.condense_merge_prepped(ai, av, bi, bv, rounds=rounds,
                                         bm=bm, bn=bn)
    return out[:m, :n]


# ----------------------------------------------------------------------
def spmm(a, b, *, bm: int = 128, bn: Optional[int] = None,
         variant: str = "auto", rounds: Optional[int] = None, device=None,
         mesh=None, axis=None, tuned=None) -> torch.Tensor:
    """C = A @ B, dispatched on the format of A.

      * ``PreparedOperand`` / ``InCRS``  -> fused InCRS SpMM (``variant``
        picks the grid order; ``auto`` rides ``tuned``, a plan's
        ``autotune.TunedConfig``, or the tuning cache, else the cost
        model's order);
      * ``ShardedPreparedOperand`` (or a raw ``InCRS`` with ``mesh=``, a
        ``launch.mesh.Mesh``, split over ``axis``) -> row-sharded fused
        SpMM: one launch a shard on its own device, C gathered on the
        first shard's device;
      * ``CRS`` x ``CRS``/``InCRS`` (B = the sparse B^T, row-stored) ->
        SpGEMM C = A @ B^T: ``variant`` picks "reference", "condense_merge",
        "densify" or "auto" (the cost model's engine); window =
        ``rounds`` (None: the tuned window, else 128);
      * ``BSR``                          -> block-sparse kernel steered by
        the block-row prefix counters;
      * a dense 2-D array or tensor      -> tiled dense kernel.

    Returns C[:M, :N] unpadded, f32 accumulation everywhere; the BSR
    product takes ``b.dtype`` and the dense one ``a.dtype``, as in the JAX
    package. ``mesh`` on any other format raises: sharding is the InCRS
    data path.
    """
    if isinstance(a, ShardedPreparedOperand):
        if mesh is not None and mesh is not a.mesh:
            raise ValueError("the ShardedPreparedOperand is bound to its "
                             "own mesh; drop mesh=, or re-prep the raw "
                             "InCRS on the new mesh")
        return _spmm_incrs_sharded(a, b, bm=bm, bn=bn, variant=variant,
                                   tuned=tuned)
    if isinstance(a, (PreparedOperand, InCRS)):
        if mesh is not None:
            if not isinstance(a, InCRS):
                raise ValueError(
                    "cannot re-shard an already-built single-device "
                    "PreparedOperand; pass the raw InCRS with mesh=, or "
                    "a ShardedPreparedOperand")
            return _spmm_incrs_sharded(a, b, mesh=mesh, axis=axis, bm=bm,
                                       bn=bn, variant=variant, tuned=tuned)
        return _spmm_incrs(a, b, bm=bm, bn=bn, variant=variant,
                           device=device, tuned=tuned)
    if mesh is not None:
        raise ValueError(f"mesh sharding is the InCRS data path; a "
                         f"{type(a).__name__} operand does not shard")
    if isinstance(a, BSR):
        return _spmm_bsr(a, b, device=device)
    if isinstance(a, CRS):
        if not isinstance(b, (CRS, InCRS)):
            raise TypeError(
                "spmm with a CRS left operand runs sparse x sparse "
                "C = A @ B^T and needs B^T sparse too (CRS or InCRS); "
                "densify one side or use the InCRS path for "
                "sparse-times-dense")
        return _spmm_spgemm(a, b, rounds=rounds, bm=bm, bn=bn,
                            variant=variant, device=device)
    if getattr(a, "ndim", None) == 2:
        return dense_mm(a, b, device=device)
    raise TypeError(f"spmm does not know the operand format "
                    f"{type(a).__name__}; expected PreparedOperand, "
                    f"ShardedPreparedOperand, InCRS, BSR, CRS or a dense "
                    f"2-D array")


# ----------------------------------------------------------------------
def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: Optional[int] = None, soft_cap=None,
              bq: Optional[int] = None,
              bk: Optional[int] = None, q_offset: int = 0) -> torch.Tensor:
    """Grouped-query flash attention through the flash kernel.

    q: (B, Sq, KV, G, hd); k/v: (B, Sk, KV, hd). Causal over absolute
    positions 0..S-1 (prefill/train layout), with an optional sliding
    ``window`` and tanh ``soft_cap``. Returns (B, Sq, KV, G, hd) in
    ``q.dtype``, on the device of q. ``q_offset`` (not in JAX's
    signature; JAX takes query positions from its own ``pos``) puts query
    row r at position r + q_offset: a span of a longer sequence, keys from
    0.

    ``bq``/``bk`` keep the JAX signature, where they are the Pallas tiles
    that Sq and Sk are padded to. None of those tile rules carry over: the
    CUDA kernel's 64 x 64 tiles are fixed by the shared memory they take,
    and it masks its ragged tiles and reads this layout through strides,
    so nothing is padded or transposed. ``bq`` is unused; ``bk`` is the key
    chunk of the plain version that CPU tensors run (default 1024, the
    model's ``flash_chunk``).
    """
    for name, t in (("bq", bq), ("bk", bk)):
        if t is not None and int(t) <= 0:
            raise ValueError(f"flash_mha: {name} must be positive, got {t}")
    return _flash_kernel(q, k, v, window=window, soft_cap=soft_cap,
                         chunk=1024 if bk is None else int(bk),
                         q_offset=q_offset)
