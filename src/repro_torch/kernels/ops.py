"""Public kernel API, InCRS part: format preparation and ``spmm``.

The port of the InCRS half of ``repro.kernels.ops``. ``prep_sections``
turns an InCRS operand into the padded per-(row, section) stripes the
kernels consume, located through the packed counter words alone;
``prepare_incrs`` memoizes that per live operand; ``spmm`` pads B, picks
the column tile and the grid order, and trims the result.

Entry points take ``device=`` and default to ``"cuda"``: without CUDA they
raise unless the caller asks for ``"cpu"``, where the kernels' plain torch
versions run. Formats other than InCRS are later slices of the port.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.crs import CRS
from ..core.incrs import InCRS
from . import incrs_spmm as _k

VARIANTS = ("auto", "expand", "reuse", "pipelined")

_INCRS_KERNELS = {"expand": _k.incrs_spmm,
                  "reuse": _k.incrs_spmm_reuse,
                  "pipelined": _k.incrs_spmm_pipelined}


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means CUDA. Asking for CUDA
    where there is none raises instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on the GPU unless the "
            "caller passes device='cpu'")
    return dev


def check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be 'auto', 'expand', 'reuse' or "
                         f"'pipelined', got {variant!r}")


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


def prepare_incrs(incrs: InCRS, *, pad_rows_to: int = 128,
                  device=None) -> PreparedOperand:
    """Prep an InCRS operand for the fused SpMM, memoized per live operand
    and device (LRU, at most ``_PREP_CACHE_MAX`` entries). The operand is
    treated as immutable once prepped: after mutating ``incrs.crs`` in
    place, call ``invalidate_prepared``."""
    dev = resolve_device(device)
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


# ----------------------------------------------------------------------
def default_bn(n: int) -> int:
    """Fewest ~512-wide col tiles, then the 128-multiple that just covers
    them: padding waste stays under 128 cols per tile."""
    np128 = -(-n // 128) * 128
    tiles = -(-np128 // 512)
    return -(-np128 // (tiles * 128)) * 128


def _spmm_incrs(a, b, *, bm: int = 128, bn: Optional[int] = None,
                variant: str = "auto", device=None) -> torch.Tensor:
    """C = A @ B through the fused InCRS kernel of the chosen grid order.
    ``a`` is an InCRS (prepped through the memo on ``device``) or a
    ``PreparedOperand`` (B is moved to its device). ``variant="auto"`` is
    the expand order until the port has a Hopper autotuner. Returns f32
    C[:M, :N]."""
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
    if variant == "auto":
        variant = "expand"
    if bn is None:
        bn = default_bn(n)
    kp = prep.n_sections * prep.section
    np_ = -(-n // bn) * bn
    b = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k))
    out = _INCRS_KERNELS[variant](prep.idx, prep.val, b,
                                  section=prep.section, bm=bm, bn=bn)
    return out[:m, :n]


def spmm(a, b, *, bm: int = 128, bn: Optional[int] = None,
         variant: str = "auto", device=None, mesh=None) -> torch.Tensor:
    """C = A @ B, dispatched on the format of A. ``PreparedOperand`` and
    ``InCRS`` run the fused InCRS SpMM; the other formats of the JAX
    package are later slices of the port and raise."""
    if mesh is not None:
        raise NotImplementedError(
            "row-sharded SpMM is not ported yet (ROADMAP queue 1 item 8)")
    if isinstance(a, (PreparedOperand, InCRS)):
        return _spmm_incrs(a, b, bm=bm, bn=bn, variant=variant,
                           device=device)
    if isinstance(a, CRS):
        raise NotImplementedError(
            "CRS index matching and SpGEMM are not ported yet (ROADMAP "
            "queue 1 item 7)")
    if getattr(a, "ndim", None) == 2:
        raise NotImplementedError(
            "the dense tiled matmul is not ported yet (ROADMAP queue 1 "
            "item 6)")
    raise TypeError(f"spmm does not know the operand format "
                    f"{type(a).__name__}; the port serves PreparedOperand "
                    f"and InCRS (BSR is ROADMAP queue 1 item 5)")
