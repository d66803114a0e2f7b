"""Fused InCRS SpMM: C[M, N] = decompress(idx, val) @ B, three grid orders.

The port of ``repro.kernels.incrs_spmm``. Each entry point keeps the
contract of its Pallas counterpart (same arguments, same row padding and
grid checks, f32 output of shape (M, N)) and reaches a CUDA kernel written
by hand for Hopper in ``csrc/incrs_spmm.cu``:

* ``incrs_spmm``           — expand order: a block per (row tile, col
  tile), looping over sections, each lane gathering float4s of B rows;
* ``incrs_spmm_reuse``     — each stripe reused over a panel of up to 512
  columns whose sums stay in registers;
* ``incrs_spmm_pipelined`` — (section, 64) blocks of B streamed by TMA
  through an mbarrier ring, multicast to a cluster of CTAs on adjacent row
  tiles, and shared by each CTA's rows.

All three stage their rows' stripes in shared memory two sections ahead,
compacted to the live slots.

A tensor on the CPU takes the plain torch version beside each kernel (the
CPU tests use it); a CUDA tensor launches the kernel or raises. The three
kernels sum every output element in the same order and agree bit for bit.
``LAUNCHES`` counts the kernel launches of each entry point.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import _alloc, _build
from .ref import incrs_decompress

# Row tiles are kept to multiples of this, as in the Pallas contract, so a
# row-padded operand has the same shape in both packages.
_SUBLANE = 8

# Shared memory one block may use on an H100 (227 KB), after opting in.
SMEM_LIMIT = 232_448

LAUNCHES: Dict[str, int] = {"incrs_spmm": 0, "incrs_spmm_reuse": 0,
                            "incrs_spmm_pipelined": 0}
# ops.spmm's grid orders and the kernel of each
ORDERS = {"expand": "incrs_spmm", "reuse": "incrs_spmm_reuse",
          "pipelined": "incrs_spmm_pipelined"}

_C_FN = {"incrs_spmm": "incrs_spmm_expand",
         "incrs_spmm_reuse": "incrs_spmm_reuse",
         "incrs_spmm_pipelined": "incrs_spmm_pipelined"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _resolve_row_tile(m: int, bm: int) -> Tuple[int, int]:
    """Shrink ``bm`` to the sublane-rounded panel height, then pad the
    panel up to a whole number of tiles. Returns ``(bm, padded_m)``."""
    bm = max(1, min(bm, -(-m // _SUBLANE) * _SUBLANE))
    return bm, -(-m // bm) * bm


def _pad_rows(idx: torch.Tensor, val: torch.Tensor,
              padded_m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad the row axis with empty stripes (idx=-1 rows add nothing)."""
    m = idx.shape[0]
    if padded_m == m:
        return idx, val
    pad = (0, 0, 0, 0, 0, padded_m - m)
    return (torch.nn.functional.pad(idx, pad, value=-1),
            torch.nn.functional.pad(val, pad))


def _check_grid(m: int, n: int, bm: int, bn: int,
                k: int, n_sections: int, section: int) -> None:
    if m % bm != 0 or n % bn != 0:
        raise ValueError(
            f"operand ({m}, {n}) not tileable by (bm={bm}, bn={bn})")
    if k != n_sections * section:
        raise ValueError(
            f"dense operand has {k} rows, InCRS stripes describe "
            f"{n_sections} x {section} = {n_sections * section}")


# ----------------------------------------------------------------------
# Plain torch versions: the Pallas arithmetic (a dense (rows, section) slab
# per stripe, contracted against B) in each grid order, run for CPU tensors.
def _slab(idx: torch.Tensor, val: torch.Tensor, s: int,
          section: int) -> torch.Tensor:
    return incrs_decompress(idx[:, s:s + 1], val[:, s:s + 1], section,
                            section)


def _plain_expand(idx, val, b, *, section: int, bn: int) -> torch.Tensor:
    """Grid (col tile, section): every col tile re-expands each stripe."""
    mp, n_sections, _ = idx.shape
    b = b.to(torch.float32)
    out = torch.empty(mp, b.shape[1], dtype=torch.float32, device=b.device)
    for j in range(0, b.shape[1], bn):
        acc = torch.zeros(mp, bn, dtype=torch.float32, device=b.device)
        for s in range(n_sections):
            acc += _slab(idx, val, s, section) @ \
                b[s * section:(s + 1) * section, j:j + bn]
        out[:, j:j + bn] = acc
    return out


def _plain_panel(idx, val, b, *, section: int, bn: int) -> torch.Tensor:
    """Grid (section, col tile): each stripe expanded once and swept over
    every col tile into a row panel. Both the reuse and the pipelined
    order compute this; the ring changes where B sits, not the sums."""
    _, n_sections, _ = idx.shape
    b = b.to(torch.float32)
    panel = None
    for s in range(n_sections):
        slab = _slab(idx, val, s, section)
        rows = b[s * section:(s + 1) * section]
        contrib = torch.cat([slab @ rows[:, j:j + bn]
                             for j in range(0, b.shape[1], bn)], dim=1)
        panel = contrib if panel is None else panel + contrib
    return panel


_PLAIN = {"incrs_spmm": _plain_expand,
          "incrs_spmm_reuse": _plain_panel,
          "incrs_spmm_pipelined": _plain_panel}


# ----------------------------------------------------------------------
def _library() -> ctypes.CDLL:
    lib = _build.library("incrs_spmm")
    if not getattr(lib, "_repro_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        # After (idx, val, B, C, M, N, sections, smax, section): what the
        # wrapper sizes (launch_geometry), then the device and the stream.
        for name, fn in _C_FN.items():
            f = getattr(lib, fn)
            f.argtypes = [p, p, p, p, i, i, i, i, i,
                          *_GEOMETRY_TYPES[name], i, p]
            f.restype = i
        lib.incrs_ctas_per_sm.argtypes = [i, i, i, ctypes.c_size_t, p]
        lib.incrs_ctas_per_sm.restype = i
        lib.incrs_error_string.argtypes = [i]
        lib.incrs_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


# The launch geometry, computed here only: the C launchers take it as
# given. The constants are the kernels' own (csrc/incrs_spmm.cu).
REUSE_THREADS = 256
REUSE_COLS_PER_THREAD = 4
REUSE_TPR = (32, 64, 128)              # reuse_kernel<TPR> instances
EXPAND_ROWS = (8, 4, 2, 1)             # warps (one row each) per CTA
EXPAND_COLS = 128                      # a lane's float4 x 32 lanes
PIPE_MAX_WARPS = 31                    # consumer warps (+ one producer)
PIPE_COLS = 32                         # lanes: a block is 32 * CPL columns
PIPE_CPL = (2, 1)                      # pipelined_kernel<CPL>, as tried
PIPE_BLOCKS = 2                        # column blocks per CTA
PIPE_STAGES = 3                        # ring stages
PIPE_CLUSTER = 2                       # CTAs on adjacent row tiles
TMA_BOX_MAX = 256                      # rows of one TMA box
# An H100 SXM: 132 SMs, each with 2,048 threads and 228 KB of shared
# memory, 1 KB of it reserved for each resident block.
SMS, SM_THREADS, SM_SMEM, CTA_RESERVED = 132, 2048, 233_472, 1024
_GEOMETRY_TYPES = {"incrs_spmm": (ctypes.c_int, ctypes.c_size_t),
                   "incrs_spmm_reuse": (ctypes.c_int, ctypes.c_size_t),
                   "incrs_spmm_pipelined": (ctypes.c_int,) * 8 +
                   (ctypes.c_size_t,)}


class PipeGeometry(NamedTuple):
    """What the pipelined launcher takes: the instance (columns per lane:
    blocks of 32 * CPL columns), the consumer warps (one row each), the
    cluster, the ring (PIPE_STAGES stages of cluster * boxes * box_rows
    rows), the grid, and the shared memory of one CTA."""
    cols_per_lane: int
    warps: int
    cluster: int
    stages: int
    box_rows: int
    boxes: int
    row_tiles: int
    col_tiles: int
    smem: int


def stripe_bytes(rows: int, smax: int) -> int:
    """Shared memory of the staged stripes of ``rows`` rows (every order,
    ``Stripes::bytes``): two raw stripes (idx and val, each row ``smax``
    rounded up to 4, plus 4, for 16-byte copies from any offset), two
    compacted ones ((idx, val) pairs, each row ``smax`` rounded up to 2)
    and 16 bytes of live counts per row."""
    return 16 * rows * (-(-smax // 4) * 4 + 4 + -(-smax // 2) * 2 + 1)


def reuse_geometry(n: int, tpr: Optional[int] = None
                   ) -> Tuple[int, int, int]:
    """(threads per row, rows per block, panel columns) of the reuse
    kernel at N columns: 32, 64 or 128 threads a row (the kernel's three
    instances), the fewest whose panel of 128, 256 or 512 columns holds N,
    else 128; 256 threads a block. ``tpr`` overrides the rule (sweeps)."""
    if tpr is None:
        cols = -(-n // REUSE_COLS_PER_THREAD)    # threads a row would use
        tpr = next((t for t in REUSE_TPR[:-1] if cols <= t), REUSE_TPR[-1])
    return tpr, REUSE_THREADS // tpr, REUSE_COLS_PER_THREAD * tpr


def reuse_smem_bytes(n: int, smax: int, tpr: Optional[int] = None) -> int:
    """Shared memory per block of the reuse kernel: its rows' stripes."""
    return stripe_bytes(reuse_geometry(n, tpr)[1], smax)


def expand_geometry(smax: int, rows: Optional[int] = None
                    ) -> Tuple[int, int]:
    """(rows per CTA, shared memory) of the expand kernel: 8 warps of one
    row each, each with its own stripes, fewer only where 8 rows' stripes
    would not fit. ``rows`` overrides the rule (sweeps)."""
    if rows is not None:
        return rows, stripe_bytes(rows, smax)
    for rows in EXPAND_ROWS:
        smem = stripe_bytes(rows, smax)
        if smem <= SMEM_LIMIT:
            return rows, smem
    raise ValueError(f"incrs_spmm: needs {smem} bytes of shared memory per "
                     f"block for one row's stripes (smax {smax}), over the "
                     f"card's {SMEM_LIMIT}")


def pipe_launch(m: int, n: int, smax: int, section: int, cpl: int,
                warps: int, cluster: int) -> PipeGeometry:
    """The pipelined launch of ``cpl`` columns a lane, ``warps`` consumer
    warps and a cluster of ``cluster`` (dividing the section) at M
    (padded) rows and N columns: each CTA copies section / C rows of each
    block in boxes of at most 256 rows; row tiles padded to a multiple of
    the cluster."""
    q = section // cluster
    boxes = -(-q // TMA_BOX_MAX)
    box_rows = -(-q // boxes)
    ring = PIPE_STAGES * (cluster * boxes * box_rows * PIPE_COLS * cpl * 4 +
                          16)
    tiles = -(-m // warps)
    return PipeGeometry(cpl, warps, cluster, PIPE_STAGES, box_rows, boxes,
                        -(-tiles // cluster) * cluster,
                        -(-n // (PIPE_COLS * cpl * PIPE_BLOCKS)),
                        128 + ring + stripe_bytes(warps, smax))


@functools.lru_cache(maxsize=256)
def pipelined_geometry(m: int, n: int, smax: int, section: int, *,
                       cluster: int = PIPE_CLUSTER,
                       cols_per_lane: Optional[int] = None,
                       warps: Optional[int] = None,
                       sms: int = SMS) -> PipeGeometry:
    """The pipelined launch at M (padded) rows and N columns on a card of
    ``sms`` SMs.

    The cluster is the largest of ``cluster``, ``cluster / 2``, ... that
    divides the section, so each CTA copies section / C rows of each
    block, in boxes of at most 256 rows. Two columns a lane (unless
    given) where the ring of 64-column blocks fits the card's shared
    memory, else one: they halve the shared-memory loads of the slot
    loop. A CTA's time grows with its rows (one a consumer warp) on top of
    a fixed cost per ring stage, so the consumer warps (unless given) are
    the fewest that still launch the grid in the fewest waves the shared
    memory allows; where padding the row tiles to a whole number of
    clusters costs a wave, the launch takes no cluster (C = 1) instead.
    Row tiles are padded to a multiple of the cluster (the kernel masks
    rows past M). Raises if nothing fits. Memoized: a serving loop pays
    for the search once per shape."""
    while section % cluster:
        cluster //= 2

    def launch(cpl: int, w: int, c: int) -> PipeGeometry:
        return pipe_launch(m, n, smax, section, cpl, w, c)

    def cost(g: PipeGeometry) -> tuple:
        per_sm = assumed_ctas_per_sm("incrs_spmm_pipelined", g)
        return (-(-g.row_tiles * g.col_tiles // (per_sm * sms)), g.warps,
                g.cluster != cluster)

    for cpl in PIPE_CPL:
        if cols_per_lane not in (None, cpl):
            continue
        fits = [launch(cpl, w, c)
                for w in (range(1, PIPE_MAX_WARPS + 1) if warps is None
                          else (warps,))
                for c in sorted({cluster, 1})]
        fits = [g for g in fits if g.smem <= SMEM_LIMIT]
        if fits:
            return min(fits, key=cost)
    raise ValueError(f"incrs_spmm_pipelined: needs more than the card's "
                     f"{SMEM_LIMIT} bytes of shared memory per block (smax "
                     f"{smax}, section {section})")


# Each order's launch knobs (``launch_geometry``'s keyword arguments):
# what the autotuner sweeps.
KNOBS = {"incrs_spmm": ("rows",), "incrs_spmm_reuse": ("tpr",),
         "incrs_spmm_pipelined": ("cluster", "cols_per_lane", "warps")}


def launch_geometry(name: str, n: int, smax: int, section: int, *,
                    m: int = 0, sms: int = SMS, **knobs) -> tuple:
    """What the C launcher of kernel ``name`` takes after the operand
    sizes: (rows per CTA, shared memory) for expand, (threads per row,
    shared memory) for reuse, a ``PipeGeometry`` for pipelined (at ``m``
    rows on ``sms`` SMs). ``knobs`` (``KNOBS[name]``) override the rule:
    ``rows`` of expand, ``tpr`` of reuse, ``pipelined_geometry``'s
    keyword arguments. Raises if a block would need more shared memory
    than the card has; ``analysis.launch_check`` holds an overridden
    geometry against the rest of what the kernel takes."""
    bad = set(knobs) - set(KNOBS[name])
    if bad:
        raise ValueError(f"{name}: no launch knob {sorted(bad)}; it has "
                         f"{list(KNOBS[name])}")
    if name == "incrs_spmm_pipelined":
        return pipelined_geometry(m, n, smax, section, sms=sms, **knobs)
    if name == "incrs_spmm":
        geo = expand_geometry(smax, knobs.get("rows"))
    else:
        tpr = reuse_geometry(n, knobs.get("tpr"))[0]
        geo = tpr, reuse_smem_bytes(n, smax, tpr)
    if geo[1] > SMEM_LIMIT:
        raise ValueError(f"{name}: needs {geo[1]} bytes of shared memory "
                         f"per block, over the card's {SMEM_LIMIT}")
    return geo


def rebuild(name: str, geometry: tuple, *, m: int, n: int, smax: int,
            section: int) -> tuple:
    """The launch this wrapper builds at M (padded) rows, N columns and
    (smax, section) stripes from ``geometry``'s own knobs: equal to
    ``geometry`` exactly where it is this shape's launch (a tuned launch
    at another shape is not)."""
    if name == "incrs_spmm":
        return expand_geometry(smax, geometry[0])
    if name == "incrs_spmm_reuse":
        return geometry[0], reuse_smem_bytes(n, smax, geometry[0])
    return pipe_launch(m, n, smax, section, geometry.cols_per_lane,
                       geometry.warps, geometry.cluster)


def launch_threads(name: str, geometry: tuple) -> int:
    """Threads of one CTA of kernel ``name`` at ``geometry``."""
    if name == "incrs_spmm":
        return geometry[0] * 32
    if name == "incrs_spmm_reuse":
        return REUSE_THREADS
    return (geometry.warps + 1) * 32


def launch_grid(name: str, geometry: tuple, m: int, n: int
                ) -> Tuple[int, int, int]:
    """The (x, y, cluster) grid the C launcher of ``name`` starts at M
    (padded) rows and N columns."""
    if name == "incrs_spmm":
        return -(-m // geometry[0]), -(-n // EXPAND_COLS), 1
    if name == "incrs_spmm_reuse":
        rows = REUSE_THREADS // geometry[0]
        return (-(-m // rows), -(-n // (REUSE_COLS_PER_THREAD * geometry[0])),
                1)
    return geometry.row_tiles, geometry.col_tiles, geometry.cluster


# An SM's register file: 4 partitions of 16,384, a warp's registers in
# units of 256 within one partition.
SM_PARTITIONS, PARTITION_REGISTERS = 4, 16_384


def warps_by_registers(registers: int) -> int:
    """The warps of ``registers`` registers a thread one SM holds."""
    per_warp = -(-registers * 32 // 256) * 256
    return SM_PARTITIONS * (PARTITION_REGISTERS // per_warp)


def assumed_ctas_per_sm(name: str, geometry: tuple,
                        registers: Optional[int] = None) -> int:
    """The CTAs of ``name`` at ``geometry`` that one SM holds, as the
    wrapper counts them: by threads and shared memory (1 KB reserved a
    CTA), and by registers where ``registers`` a thread are known
    (``warps_by_registers``)."""
    threads = launch_threads(name, geometry)
    smem = geometry.smem if name == "incrs_spmm_pipelined" else geometry[1]
    ctas = min(32, SM_THREADS // threads, SM_SMEM // (smem + CTA_RESERVED))
    if registers:
        ctas = min(ctas, warps_by_registers(registers) // -(-threads // 32))
    return ctas


# ids of incrs_ctas_per_sm's `kernel` argument
_KERNEL_IDS = {"incrs_spmm": 0, "incrs_spmm_reuse": 1,
               "incrs_spmm_pipelined": 2}


def instance_of(name: str, geometry: tuple, n: int = 0) -> int:
    """The template instance of ``name`` at ``geometry``: expand's float4
    form (1) where N is a multiple of 4 (the launcher's choice when B is
    16-byte aligned, as ``ops.spmm`` pads it), else 0; reuse's threads a
    row; pipelined's columns a lane."""
    if name == "incrs_spmm":
        return int(n % 4 == 0)
    if name == "incrs_spmm_reuse":
        return geometry[0]
    return geometry.cols_per_lane


def ctas_per_sm(name: str, geometry: tuple, n: int = 0) -> int:
    """The CTAs of ``name`` at ``geometry`` (N columns) that one SM of the
    current card holds, from the card's occupancy calculator."""
    lib = _library()
    out = ctypes.c_int(0)
    smem = geometry.smem if name == "incrs_spmm_pipelined" else geometry[1]
    err = lib.incrs_ctas_per_sm(_KERNEL_IDS[name],
                                instance_of(name, geometry, n),
                                launch_threads(name, geometry), smem,
                                ctypes.byref(out))
    if err:
        raise RuntimeError(f"incrs_ctas_per_sm: CUDA error {err}: "
                           f"{lib.incrs_error_string(err).decode()}")
    return out.value


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(name: str, idx: torch.Tensor, val: torch.Tensor,
            b: torch.Tensor, section: int,
            geometry: Optional[tuple] = None) -> torch.Tensor:
    """Validate, allocate C, launch the CUDA kernel on the current stream
    and count the launch. Raises on anything the kernel does not take.
    ``geometry`` replaces ``launch_geometry``'s (tuning and tests only)."""
    if idx.dtype != torch.int32 or val.dtype != torch.float32:
        raise TypeError(f"{name}: stripes must be int32/float32, got "
                        f"{idx.dtype}/{val.dtype}")
    if not b.is_floating_point():
        raise TypeError(f"{name}: B must be floating point, got {b.dtype}")
    b = b.to(torch.float32)         # exact for f16/bf16, as the Pallas body
    for t, what in ((idx, "idx"), (val, "val"), (b, "B")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    mp, n_sections, smax = idx.shape
    k, n = b.shape
    if max(mp * n_sections * smax, k * n, mp * n) >= 2 ** 31:
        raise ValueError(f"{name}: operand too large for int32 offsets "
                         f"(stripes {tuple(idx.shape)}, B {tuple(b.shape)})")
    if name == "incrs_spmm_pipelined" and (n % 4 or b.data_ptr() % 16):
        raise ValueError(f"{name}: TMA reads B in rows of 16-byte units, "
                         f"so N must be a multiple of 4 and B 16-byte "
                         f"aligned (N = {n}); ops.spmm pads N to a multiple "
                         f"of 128")
    if geometry is None:
        geometry = launch_geometry(name, n, smax, section, m=mp,
                                   sms=_sm_count(idx.device.index))
    # the stripes are staged by 16-byte copies
    idx, val = (t if t.data_ptr() % 16 == 0 else t.clone()
                for t in (idx, val))
    out = _alloc.empty((mp, n), torch.float32, idx.device)
    if mp == 0 or n == 0:
        return out
    if n_sections == 0:
        return out.zero_()
    lib = _library()
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    err = getattr(lib, _C_FN[name])(
        idx.data_ptr(), val.data_ptr(), b.data_ptr(), out.data_ptr(),
        mp, n, n_sections, smax, section, *geometry, idx.device.index,
        stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch: "
                           f"{lib.incrs_error_string(err).decode()}")
    LAUNCHES[name] += 1
    return out


def _run(name: str, idx: torch.Tensor, val: torch.Tensor, b: torch.Tensor,
         section: int, bm: int, bn: int, kernel: bool,
         geometry: Optional[tuple] = None) -> torch.Tensor:
    if len({idx.device, val.device, b.device}) != 1:
        raise ValueError(f"{name}: idx, val and B must share one device, "
                         f"got {idx.device}, {val.device}, {b.device}")
    m, n_sections, smax = idx.shape
    k, n = b.shape
    bm, mp = _resolve_row_tile(m, bm)
    _check_grid(mp, n, bm, bn, k, n_sections, section)
    if geometry is not None:        # a tuned launch: proven, never replaced
        from ..analysis import launch_check
        launch_check.require_launch(
            name, geometry=geometry, m=mp, n=n, n_sections=n_sections,
            smax=smax, section=section,
            on_card=kernel and idx.device.type == "cuda",
            context=f"{name} at geometry {tuple(geometry)}")
    idx, val = _pad_rows(idx, val, mp)
    if not kernel:
        out = _PLAIN[name](idx, val, b, section=section, bn=bn)
    elif idx.device.type == "cuda":
        out = _launch(name, idx, val, b, section, geometry)
    else:
        raise ValueError(f"{name}: no kernel for device {idx.device}")
    return out[:m] if mp != m else out


def plain(name: str, idx: torch.Tensor, val: torch.Tensor, b: torch.Tensor,
          *, section: int = 256, bm: int = 128,
          bn: int = 128) -> torch.Tensor:
    """The plain torch version of kernel ``name`` on any device, with the
    wrapper's checks and padding: what the kernel is held against."""
    return _run(name, idx, val, b, section, bm, bn, kernel=False)


def incrs_spmm(idx: torch.Tensor, val: torch.Tensor, b: torch.Tensor, *,
               section: int = 256, bm: int = 128, bn: int = 128,
               geometry: Optional[tuple] = None) -> torch.Tensor:
    """C[M, N] = decompress(idx, val) @ B without a dense A in memory.

    idx : (M, n_sections, smax) int32 local column within section, -1 = pad
    val : (M, n_sections, smax) float32 values
    b   : (n_sections * section, N) dense operand (pre-padded to bn)

    ``geometry`` (a tuned launch, ``launch_geometry``'s form) replaces
    the wrapper's own; ``analysis.launch_check`` must pass it on any
    device, else ``KernelConfigError`` is raised before the launch.
    """
    return _run("incrs_spmm", idx, val, b, section, bm, bn,
                kernel=idx.device.type != "cpu", geometry=geometry)


def incrs_spmm_reuse(idx: torch.Tensor, val: torch.Tensor, b: torch.Tensor,
                     *, section: int = 256, bm: int = 128, bn: int = 128,
                     geometry: Optional[tuple] = None) -> torch.Tensor:
    """Same contract as ``incrs_spmm``; each stripe is staged once per
    (row tile, section, 512-column panel), compacted to its live slots,
    and reused over every column of the panel."""
    return _run("incrs_spmm_reuse", idx, val, b, section, bm, bn,
                kernel=idx.device.type != "cpu", geometry=geometry)


def incrs_spmm_pipelined(idx: torch.Tensor, val: torch.Tensor,
                         b: torch.Tensor, *, section: int = 256,
                         bm: int = 128, bn: int = 128,
                         geometry: Optional[tuple] = None) -> torch.Tensor:
    """Same contract as ``incrs_spmm``; B streams by TMA through a ring in
    shared memory, shared by a cluster of CTAs. Bitwise equal to the other
    orders. On the card N must be a multiple of 4 and B 16-byte
    aligned."""
    return _run("incrs_spmm_pipelined", idx, val, b, section, bm, bn,
                kernel=idx.device.type != "cpu", geometry=geometry)
