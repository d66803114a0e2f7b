"""Counter-located section stripes -> dense rows: the InCRS gather.

The port of ``repro.kernels.incrs_gather``. ``incrs_gather`` keeps the
Pallas contract (same arguments, ``M % bm == 0``, f32 output of shape
(M, n_sections * section)) and reaches the CUDA kernels written by hand for
Hopper in ``csrc/incrs_gather.cu``. The stripes come from
``ops.prep_sections``, located through the packed counter words alone.

Two instances, chosen by ``gather_geometry``, the one source of the
launch: ``tile`` (a persistent grid of one wave; each warp builds an item
of ``sections`` sections of one row in shared memory and writes it out
once) wherever a CTA's tiles fit, and ``general`` (the first design: a
block a row, zeros then global atomics) for the rest.

A tensor on the CPU takes the plain torch version (a scatter-add onto
zeros); a CUDA tensor launches the kernel or raises. The tile instance
sums an index that repeats in a stripe in slot order, as the CPU's
scatter-add does, so the two agree bit for bit on any stripes.
``LAUNCHES`` counts the kernel's launches, ``INSTANCE_LAUNCHES`` each
instance's.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, NamedTuple, Optional

import torch

from . import _build
from .incrs_spmm import CTA_RESERVED, SM_SMEM, SMS
from .ref import incrs_decompress

LAUNCHES: Dict[str, int] = {"incrs_gather": 0}
# The ids of incrs_gather.cu's enum Instance.
INSTANCES = ("general", "tile")
INSTANCE_LAUNCHES: Dict[str, int] = {f"incrs_gather/{i}": 0
                                     for i in INSTANCES}

GENERAL_THREADS = 256
# tile: tile_kernel, 8 warps of one item each; at most 4 CTAs an SM
# (__launch_bounds__(256, 4)), fewer where their tiles do not fit.
TILE_WARPS, TILE_THREADS, TILE_MAX_CTAS = 8, 256, 4
TILE_BATCH = 512       # slots a warp has in flight (kBatch)
# The rule's item: sections up to about 160 slots, at least 2 and at most
# 6 KB of tile (6 sections of 256 columns). On the H100 (chip_smoke.py,
# spgemm_geometries; PERF.md) mesh-docword4 (77 slots a section) ran 3-10
# % slower at 1, 3, 4, 6 or 8 sections than at 2; stripes of 3 or 4 slots
# (mesh-sch, mesh-bates) 1-6 % faster at 6 than at 2.
TILE_SLOTS = 160
TILE_FLOATS = 1536
_INT31 = 2 ** 31


class GatherGeometry(NamedTuple):
    """One launch of the gather. tile: a warp's item is ``sections``
    sections of one row (``items`` in all), its tile ``tile`` floats of
    shared memory, ``grid`` persistent CTAs of ``threads``,
    ``ctas_per_sm`` of them an SM; general: a block a row (``grid`` = M),
    the tile fields 0."""
    instance: str
    sections: int
    tile: int
    smem: int
    threads: int
    ctas_per_sm: int
    items: int
    grid: int


def reset_launches() -> None:
    LAUNCHES["incrs_gather"] = 0
    for k in INSTANCE_LAUNCHES:
        INSTANCE_LAUNCHES[k] = 0


def tile_floats(sections: int, section: int) -> int:
    """A warp's tile: ``sections * section`` f32, rounded up to a float4."""
    return -(-sections * section // 4) * 4


def tile_ctas(smem: int) -> int:
    """tile_kernel's CTAs an SM at ``smem`` bytes: its launch bound, or
    what the SM's shared memory holds (1 KB of it reserved a CTA)."""
    return min(TILE_MAX_CTAS, SM_SMEM // (smem + CTA_RESERVED))


@lru_cache(maxsize=256)
def gather_geometry(m: int, n_sections: int, smax: int, section: int, *,
                    instance: Optional[str] = None,
                    sections: Optional[int] = None) -> GatherGeometry:
    """The launch of the gather on (m, n_sections, smax) stripes of
    ``section`` columns: the tile instance wherever a CTA of 8 one-section
    tiles fits an SM, else the general one. The tile's item takes as many
    sections as keep its slots near ``TILE_SLOTS`` (at least 2 sections)
    and within one batch in flight (``TILE_BATCH``), and its tile within
    ``TILE_FLOATS``; ``instance`` and ``sections``
    override the rule (sweeps). Raises ValueError where no instance takes
    the shape."""
    if instance not in (None,) + INSTANCES:
        raise ValueError(f"gather_geometry: unknown instance {instance!r}")
    if (min(m, n_sections, section) < 1 or smax < 0 or
            n_sections * smax >= _INT31):
        raise ValueError(f"gather_geometry: stripes ({m}, {n_sections}, "
                         f"{smax}) of section {section} outside the kernels' "
                         f"range")
    fits = (instance != "general" and smax >= 1 and
            tile_ctas(TILE_WARPS * tile_floats(1, section) * 4) >= 1)
    if fits:
        per = sections or min(n_sections, max(1, TILE_BATCH // smax),
                              max(1, TILE_FLOATS // section),
                              max(2, TILE_SLOTS // smax))
        if not 1 <= per <= n_sections:
            raise ValueError(f"gather_geometry: sections {per} outside "
                             f"1..{n_sections}")
        tile = tile_floats(per, section)
        smem = TILE_WARPS * tile * 4
        ctas = tile_ctas(smem)
        if ctas < 1:
            raise ValueError(f"gather_geometry: {per} sections of {section} "
                             f"a warp need {smem} bytes of shared memory a "
                             f"CTA, over an SM's")
        items = m * -(-n_sections // per)
        grid = max(1, min(SMS * ctas, -(-items // TILE_WARPS)))
        return GatherGeometry("tile", per, tile, smem, TILE_THREADS, ctas,
                              items, grid)
    if instance == "tile":
        raise ValueError(f"gather_geometry: the tile instance does not take "
                         f"smax = {smax}, section = {section}")
    return GatherGeometry("general", 0, 0, 0, GENERAL_THREADS, 0, m, m)


def _library() -> ctypes.CDLL:
    lib = _build.library("incrs_gather")
    if not getattr(lib, "_repro_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.incrs_gather_launch.argtypes = [i, p, p, p, i, i, i, i, i, i,
                                            ctypes.c_size_t, i, p]
        lib.incrs_gather_launch.restype = i
        lib.incrs_gather_ctas_per_sm.argtypes = [i, ctypes.c_size_t, p]
        lib.incrs_gather_ctas_per_sm.restype = i
        lib.incrs_gather_error_string.argtypes = [i]
        lib.incrs_gather_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _raise_on_error(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch: "
                           f"{lib.incrs_gather_error_string(err).decode()}")


def ctas_per_sm(geo: GatherGeometry) -> int:
    """The CTAs of ``geo``'s instance that one SM of the current card
    holds, from the card's occupancy calculator."""
    lib = _library()
    out = ctypes.c_int(0)
    err = lib.incrs_gather_ctas_per_sm(INSTANCES.index(geo.instance),
                                       geo.smem, ctypes.byref(out))
    _raise_on_error(lib, "incrs_gather_ctas_per_sm", err)
    return out.value


def _check(idx: torch.Tensor, val: torch.Tensor, bm: int) -> None:
    if idx.ndim != 3 or idx.shape != val.shape:
        raise ValueError(f"incrs_gather: idx and val must be one (M, "
                         f"n_sections, smax) shape, got {tuple(idx.shape)} "
                         f"and {tuple(val.shape)}")
    if idx.device != val.device:
        raise ValueError(f"incrs_gather: idx and val must share one device, "
                         f"got {idx.device} and {val.device}")
    if idx.shape[0] % bm != 0:
        raise ValueError(f"m={idx.shape[0]} must be a multiple of bm={bm}")


def _check_out(out: torch.Tensor, idx: torch.Tensor, section: int) -> None:
    shape = (idx.shape[0], idx.shape[1] * section)
    if (tuple(out.shape) != shape or out.dtype != torch.float32 or
            out.device != idx.device or not out.is_contiguous()):
        raise ValueError(f"incrs_gather: out must be a contiguous float32 "
                         f"{shape} tensor on {idx.device}")


def _launch(idx: torch.Tensor, val: torch.Tensor, section: int,
            out: Optional[torch.Tensor],
            geometry: Optional[GatherGeometry]) -> torch.Tensor:
    """Validate, allocate the dense output (or take ``out``), launch on the
    current stream in the instance ``gather_geometry`` picks (``geometry``
    overrides it) and count the launch. Raises on anything the kernels do
    not take."""
    if idx.dtype != torch.int32 or val.dtype != torch.float32:
        raise TypeError(f"incrs_gather: stripes must be int32/float32, got "
                        f"{idx.dtype}/{val.dtype}")
    if not (idx.is_contiguous() and val.is_contiguous()):
        raise ValueError("incrs_gather: idx and val must be contiguous")
    m, n_sections, smax = idx.shape
    if n_sections * smax >= _INT31:
        raise ValueError(f"incrs_gather: {n_sections} x {smax} slots per row "
                         f"overflow the kernel's int32 slot index")
    if out is None:
        out = torch.empty((m, n_sections * section), dtype=torch.float32,
                          device=idx.device)
    if out.numel() == 0:
        return out
    geo = geometry or gather_geometry(m, n_sections, smax, section)
    lib = _library()
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    err = lib.incrs_gather_launch(
        INSTANCES.index(geo.instance), idx.data_ptr(), val.data_ptr(),
        out.data_ptr(), m, n_sections, smax, section, geo.sections,
        geo.grid, geo.smem, idx.device.index, stream)
    _raise_on_error(lib, "incrs_gather", err)
    LAUNCHES["incrs_gather"] += 1
    INSTANCE_LAUNCHES[f"incrs_gather/{geo.instance}"] += 1
    return out


def plain(idx: torch.Tensor, val: torch.Tensor, *, section: int = 256,
          bm: int = 8) -> torch.Tensor:
    """The plain torch version on any device, with the wrapper's checks:
    what the kernel is held against."""
    _check(idx, val, bm)
    n_cols = idx.shape[1] * section
    return incrs_decompress(idx, val, n_cols, section)


def incrs_gather(idx: torch.Tensor, val: torch.Tensor, *, section: int = 256,
                 bm: int = 8, out: Optional[torch.Tensor] = None,
                 geometry: Optional[GatherGeometry] = None) -> torch.Tensor:
    """Dense[M, n_sections * section] f32 from padded per-section rows.

    idx : (M, n_sections, smax) int32 local column within section, -1 = pad
    val : (M, n_sections, smax) float32
    out : optional contiguous f32 (M, n_sections * section) on idx's
          device, written in full and returned
    ``geometry`` overrides ``gather_geometry`` on the card (sweeps).
    """
    if idx.device.type == "cpu":
        dense = plain(idx, val, section=section, bm=bm)
        if out is None:
            return dense
        _check_out(out, idx, section)
        return out.copy_(dense)
    _check(idx, val, bm)
    if out is not None:
        _check_out(out, idx, section)
    if idx.device.type != "cuda":
        raise ValueError(f"incrs_gather: no kernel for device {idx.device}")
    return _launch(idx, val, section, out, geometry)
