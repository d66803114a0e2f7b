"""Round-synchronized index-matching SpMM: the paper's Alg. 2, C = A @ B.T.

The port of ``repro.kernels.index_match_spmm``. Both operands are sparse
rows in the per-round padded form of ``ops.prep_rounds``:

  idx (rows, n_rounds, rmax) int32 local index in [0, R), -1 = padding
  val (rows, n_rounds, rmax) values

``index_match_spmm`` keeps the Pallas contract (same arguments, row counts
multiples of ``bm``/``bn``, f32 accumulation over rounds ascending and one
cast at the end to ``out_dtype``, by default the operands' promoted type)
and reaches the CUDA kernels written by hand for Hopper in
``csrc/index_match.cu``. That source also holds the condense and merge
kernels of ``repro_torch.spgemm``, which share its per-round partial and
therefore equal it bit for bit; ``library`` binds them all.

Two instances, chosen by ``match_geometry``, the one source of the launch:
``ring`` (the operands packed to their live slots first, then a persistent
grid of one CTA an SM walking (tile, round) items through a ring of
shared-memory stages, B's round window double buffered) wherever its
window and ring fit, and ``general`` (the first design: a CTA per 64 x
128 tile, rounds in a loop) for the rest.

A tensor on the CPU takes the plain torch version (each round's windows
densified and multiplied, f32, rounds added ascending); a CUDA tensor
launches a kernel or raises. ``LAUNCHES`` counts the kernel's launches,
``INSTANCE_LAUNCHES`` each instance's, condense's included.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import _build
from .incrs_spmm import SMEM_LIMIT
from .ref import round_densify

LAUNCHES: Dict[str, int] = {"index_match_spmm": 0}
# The ids of index_match.cu's enum Instance.
INSTANCES = ("general", "ring")
KERNELS = ("index_match_spmm", "spgemm_condense")
INSTANCE_LAUNCHES: Dict[str, int] = {f"{k}/{i}": 0 for k in KERNELS
                                     for i in INSTANCES}

SMS = 132                      # H100 SXM
# general: match_kernel, 8 warps of 8 rows x 128 columns; two CTAs an SM
# (99-104 registers a thread, ptxas).
GENERAL_TILE_M, GENERAL_TILE_N, GENERAL_THREADS = 64, 128, 256
# CUDA grid rows of 64 output rows each: gridDim.y is at most 65535.
_MAX_ROWS = GENERAL_TILE_M * 65535
# ring: ring_kernel, 14 consumer warps of rows_per_warp rows x 128 columns,
# a warp that builds B's windows and one that starts the copies; one CTA an
# SM (__launch_bounds__(512, 1)).
RING_WARPS, RING_COLS, RING_THREADS = 14, 128, 512
RING_MAX_ROWS_PER_WARP = 16
RING_MAX_ROUNDS = 256          # an entry's index bits (row << 8 | index)
RING_MAX_ROWS = 2 ** 23        # an entry's row bits
RING_MAX_N_ROUNDS = 65_535     # the pre-pass grid's y
RING_STAGES = 5                # default ring depth
RING_STAGES_RANGE = (4, 12)    # the window warp clears item u - 1's entries
                               # while item u + 1 lands
RING_MIN_CAP = 2048            # entry bytes a stage must hold at least
# What an item costs beside its rows' lookups (the B window's clear and
# scatter, the barrier, the stage), in rows of lookups: the rows-per-warp
# rule trades it against waves.
RING_ITEM_ROWS = 32
CTAS_PER_SM = {"general": 2, "ring": 1}
_INT31 = 2 ** 31


class MatchGeometry(NamedTuple):
    """One launch of index matching (``stripes`` False) or condense
    (True). ``tile_m`` x ``tile_n`` outputs a tile; ring: ``stages``
    stages of ``cap`` entry bytes, ``grid`` persistent CTAs, condense
    ``chunk`` (tile, round) items a CTA; general: a (col_tiles,
    row_tiles) grid, the ring fields 0."""
    instance: str
    stripes: bool
    tile_m: int
    tile_n: int
    rows_per_warp: int
    stages: int
    cap: int
    smem: int
    threads: int
    row_tiles: int
    col_tiles: int
    grid: int
    chunk: int

    @property
    def tiles(self) -> int:
        return self.row_tiles * self.col_tiles


def reset_launches() -> None:
    LAUNCHES["index_match_spmm"] = 0
    for k in INSTANCE_LAUNCHES:
        INSTANCE_LAUNCHES[k] = 0


def general_smem(rounds: int) -> int:
    """match_kernel's dense window: 128 B rows of ``rounds | 1`` f32."""
    return GENERAL_TILE_N * (rounds | 1) * 4


def ring_smem(rounds: int, tile_m: int, stages: int, cap: int) -> int:
    """ring_kernel's shared memory (``ring_smem_bytes``): two B windows of
    ``rounds`` x 128 f32; ``stages`` stages of A's tile_m + 1 offsets and
    B's 129 (each behind a head of up to 3 ints, in 16-byte units) and
    ``cap`` entry bytes; three mbarriers a stage and two a window."""
    off_a = (tile_m + 7) // 4 * 4
    off_b = (RING_COLS + 7) // 4 * 4
    return (2 * rounds * RING_COLS * 4 +
            stages * ((off_a + off_b) * 4 + cap) + 24 * stages + 32)


def ring_cap(rounds: int, tile_m: int, stages: int) -> int:
    """The entry bytes a stage gets from what the windows leave (a
    multiple of 16; below ``RING_MIN_CAP`` the ring does not fit)."""
    free = SMEM_LIMIT - ring_smem(rounds, tile_m, stages, 0)
    return max(0, free // stages // 16 * 16)


def _rows_per_warp(m: int, col_tiles: int, n_rounds: int,
                   stripes: bool) -> int:
    """Fused: the fewest waves of tiles over the SMs, each CTA's time
    taken as its rows plus ``RING_ITEM_ROWS``; condense: the least total
    work, its items spread evenly. Ties go to the taller tile (fewer
    re-reads of B)."""
    def cost(rpw):
        tile_m = RING_WARPS * rpw
        tiles = -(-m // tile_m) * col_tiles
        per_item = min(tile_m, m) + RING_ITEM_ROWS
        if stripes:
            return tiles * n_rounds * per_item / SMS
        return -(-tiles // SMS) * n_rounds * per_item
    return min(range(RING_MAX_ROWS_PER_WARP, 0, -1), key=cost)


@lru_cache(maxsize=256)
def match_geometry(m: int, n: int, n_rounds: int, rmax_a: int, rmax_b: int,
                   rounds: int, kernel: str = "index_match_spmm", *,
                   instance: Optional[str] = None,
                   rows_per_warp: Optional[int] = None,
                   stages: Optional[int] = None,
                   chunk: Optional[int] = None) -> MatchGeometry:
    """The launch of ``kernel`` (``index_match_spmm`` or
    ``spgemm_condense``) on A (m, n_rounds, rmax_a) and B (n, n_rounds,
    rmax_b) with round windows of ``rounds``: the ring instance wherever
    its two windows and a ring of at least 4 stages of ``RING_MIN_CAP``
    entry bytes fit in shared memory and its packed entries (row << 8 |
    index), offsets and rounds fit their fields, else the general one.
    ``instance``, ``rows_per_warp``, ``stages`` and ``chunk`` (condense:
    items a CTA) override the rule (sweeps). Raises ValueError where no
    instance takes the shape."""
    if kernel not in KERNELS:
        raise ValueError(f"match_geometry: unknown kernel {kernel!r}")
    if instance not in (None,) + INSTANCES:
        raise ValueError(f"match_geometry: unknown instance {instance!r}")
    stripes = kernel == "spgemm_condense"
    col_tiles = -(-n // RING_COLS)
    fits = (instance != "general" and 1 <= m < RING_MAX_ROWS and
            1 <= n < RING_MAX_ROWS and rounds <= RING_MAX_ROUNDS and
            n_rounds <= RING_MAX_N_ROUNDS and
            m * rmax_a < _INT31 and n * rmax_b < _INT31)
    if fits:
        rpw = rows_per_warp or _rows_per_warp(m, col_tiles, n_rounds,
                                              stripes)
        if not 1 <= rpw <= RING_MAX_ROWS_PER_WARP:
            raise ValueError(f"match_geometry: rows_per_warp {rpw} outside "
                             f"1..{RING_MAX_ROWS_PER_WARP}")
        tile_m = RING_WARPS * rpw
        lo, hi = RING_STAGES_RANGE
        if stages is not None and not lo <= stages <= hi:
            raise ValueError(f"match_geometry: stages {stages} outside "
                             f"{lo}..{hi}")
        order = [stages] if stages else list(range(RING_STAGES, lo - 1,
                                                   -1))
        depth = next((s for s in order
                      if ring_cap(rounds, tile_m, s) >= RING_MIN_CAP), None)
        row_tiles = -(-m // tile_m)
        fits = depth is not None and row_tiles * col_tiles < _INT31
    if fits:
        cap = ring_cap(rounds, tile_m, depth)
        tiles = row_tiles * col_tiles
        slots = SMS * CTAS_PER_SM["ring"]
        if stripes:
            items = tiles * n_rounds
            per = chunk or -(-items // slots)
            grid = -(-items // per)
        else:
            per, grid = 0, min(tiles, slots)
        return MatchGeometry("ring", stripes, tile_m, RING_COLS, rpw, depth,
                             cap, ring_smem(rounds, tile_m, depth, cap),
                             RING_THREADS, row_tiles, col_tiles, grid, per)
    if instance == "ring":
        raise ValueError(f"match_geometry: the ring instance does not take "
                         f"R = {rounds}, M = {m}, N = {n}")
    smem = general_smem(rounds)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{kernel}: a dense round window of R={rounds} "
                         f"needs {smem} bytes of shared memory per block, "
                         f"over the card's {SMEM_LIMIT}")
    if m > _MAX_ROWS:
        raise ValueError(f"{kernel}: M={m} outside the kernel's grid "
                         f"(M <= {_MAX_ROWS})")
    row_tiles = -(-m // GENERAL_TILE_M)
    col_tiles = -(-n // GENERAL_TILE_N)
    return MatchGeometry("general", stripes, GENERAL_TILE_M, GENERAL_TILE_N,
                         0, 0, 0, smem, GENERAL_THREADS, row_tiles,
                         col_tiles, row_tiles * col_tiles, 0)


def library() -> ctypes.CDLL:
    """``csrc/index_match.cu`` built and bound: index_match_launch (both
    instances of index matching and condense), index_match_pack (the
    ring's pre-pass alone), spgemm_merge (both instances of merge) and
    the occupancy of each instance, index_match_ctas_per_sm and
    spgemm_merge_ctas_per_sm."""
    lib = _build.library("index_match")
    if not getattr(lib, "_repro_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.index_match_launch.argtypes = [
            i, i, p, p, p, p, p, i, i, i, i, i, i, p, p, p, p, i, i, i, i,
            ll, ctypes.c_size_t, i, p]
        lib.index_match_launch.restype = i
        lib.spgemm_merge.argtypes = [i, p, p, ll, i, i, i, i,
                                     ctypes.c_size_t, i, p]
        lib.spgemm_merge.restype = i
        lib.spgemm_merge_ctas_per_sm.argtypes = [i, ctypes.c_size_t, p]
        lib.spgemm_merge_ctas_per_sm.restype = i
        lib.index_match_pack.argtypes = [p, p, p, p, i, i, i, i, i, i, p,
                                         p, p, p, i, p]
        lib.index_match_pack.restype = i
        lib.index_match_ctas_per_sm.argtypes = [i, i, ctypes.c_size_t, p]
        lib.index_match_ctas_per_sm.restype = i
        lib.index_match_error_string.argtypes = [i]
        lib.index_match_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def ctas_per_sm(geo: MatchGeometry) -> int:
    """The CTAs of ``geo``'s instance that one SM of the current card
    holds, from the card's occupancy calculator."""
    lib = library()
    out = ctypes.c_int(0)
    err = lib.index_match_ctas_per_sm(int(geo.stripes),
                                      INSTANCES.index(geo.instance),
                                      geo.smem, ctypes.byref(out))
    raise_on_error(lib, "index_match_ctas_per_sm", err)
    return out.value


def raise_on_error(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch: "
                           f"{lib.index_match_error_string(err).decode()}")


def check_operands(name: str, a_idx: torch.Tensor, a_val: torch.Tensor,
                   b_idx: torch.Tensor, b_val: torch.Tensor, bm: int,
                   bn: int) -> Tuple[int, int, int]:
    """The Pallas wrappers' checks: one device, idx/val pairs of one 3-D
    shape, equal round counts, rows aligned to the tiles. Returns
    ``(M, N, n_rounds)``."""
    if len({a_idx.device, a_val.device, b_idx.device, b_val.device}) != 1:
        raise ValueError(f"{name}: the four operand arrays must share one "
                         f"device")
    for idx, val, side in ((a_idx, a_val, "A"), (b_idx, b_val, "B")):
        if idx.ndim != 3 or idx.shape != val.shape:
            raise ValueError(f"{name}: {side} idx and val must be one (rows, "
                             f"n_rounds, rmax) shape, got {tuple(idx.shape)} "
                             f"and {tuple(val.shape)}")
    m, n_rounds, _ = a_idx.shape
    n, n_rounds_b, _ = b_idx.shape
    if n_rounds != n_rounds_b:
        raise ValueError(
            f"operand round counts differ: {n_rounds} vs {n_rounds_b}")
    if m % bm or n % bn:
        raise ValueError(f"shape {(m, n)} must align to tiles {(bm, bn)} "
                         f"(ops.index_match_prepped pads)")
    return m, n, n_rounds


def round_partial(a_idx: torch.Tensor, a_val: torch.Tensor,
                  b_idx: torch.Tensor, b_val: torch.Tensor, t: int,
                  rounds: int) -> torch.Tensor:
    """Plain f32 partial of round ``t``: A's and B's round-t windows
    densified to (rows, R) and multiplied, A_t @ B_t.T."""
    da = round_densify(a_idx[:, t:t + 1], a_val[:, t:t + 1], rounds, rounds)
    db = round_densify(b_idx[:, t:t + 1], b_val[:, t:t + 1], rounds, rounds)
    return da @ db.T


def _packed(rows: int, n_rounds: int, rmax: int, device
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scratch of the ring instance's packed copy of one operand: room for
    every slot as an (idx, val) pair and rows + 1 offsets a round, each
    with 16 bytes to spare."""
    ent = torch.empty(2 * n_rounds * rows * rmax + 4, dtype=torch.int32,
                      device=device)
    off = torch.empty(n_rounds * (rows + 1) + 4, dtype=torch.int32,
                      device=device)
    return ent, off


def pack(a_idx: torch.Tensor, a_val: torch.Tensor, b_idx: torch.Tensor,
         b_val: torch.Tensor, rounds: int) -> Tuple[torch.Tensor, ...]:
    """The ring instance's pre-pass alone on the card (f32 values,
    contiguous operands): each operand's live slots packed round-major,
    ``(ent_a, off_a, ent_b, off_b)``; round t's entries of an operand of
    ``rows`` rows start at ``2 * t * rows * rmax`` of its ``ent`` (int32
    pairs (idx, val bits)), row r's at ``off[t * (rows + 1) + r]`` after
    that. Not counted as a launch: what ``chip_smoke.py`` times apart."""
    m, n_rounds, rmax_a = a_idx.shape
    n, _, rmax_b = b_idx.shape
    dev = a_idx.device
    ent_a, off_a = _packed(m, n_rounds, rmax_a, dev)
    ent_b, off_b = _packed(n, n_rounds, rmax_b, dev)
    lib = library()
    err = lib.index_match_pack(
        a_idx.data_ptr(), a_val.data_ptr(), b_idx.data_ptr(),
        b_val.data_ptr(), m, n, n_rounds, rmax_a, rmax_b, rounds,
        ent_a.data_ptr(), off_a.data_ptr(), ent_b.data_ptr(),
        off_b.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(lib, "index_match_pack", err)
    return ent_a, off_a, ent_b, off_b


def launch_match(name: str, a_idx: torch.Tensor, a_val: torch.Tensor,
                 b_idx: torch.Tensor, b_val: torch.Tensor, out: torch.Tensor,
                 rounds: int, geometry: Optional[MatchGeometry] = None
                 ) -> Optional[MatchGeometry]:
    """Validate and launch ``index_match_spmm`` (``out`` is C, (M, N)) or
    ``spgemm_condense`` (``out`` is S, (n_rounds, M, N)) on the current
    stream, in the instance ``match_geometry`` picks (``geometry``
    overrides it: sweeps). Values are taken as f32 (exact for f16/bf16).
    Raises on anything the kernels do not take and on a CUDA error at
    launch. Returns the geometry that ran, or None where an empty ``out``
    needs no launch."""
    if a_idx.dtype != torch.int32 or b_idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32, got {a_idx.dtype}/"
                        f"{b_idx.dtype}")
    if not (a_val.is_floating_point() and b_val.is_floating_point()):
        raise TypeError(f"{name}: values must be floating point, got "
                        f"{a_val.dtype}/{b_val.dtype}")
    a_val = a_val.to(torch.float32)
    b_val = b_val.to(torch.float32)
    for t, what in ((a_idx, "A idx"), (a_val, "A val"), (b_idx, "B idx"),
                    (b_val, "B val")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    m, n_rounds, rmax_a = a_idx.shape
    n, _, rmax_b = b_idx.shape
    if not 1 <= rounds < 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"{name}: rounds={rounds}, N={n} outside the "
                         f"kernels' range")
    geo = geometry or match_geometry(m, n, n_rounds, rmax_a, rmax_b, rounds,
                                     name)
    if geo.stripes != (name == "spgemm_condense"):
        raise ValueError(f"{name}: geometry of the other kernel")
    if out.numel() == 0:
        return None
    dev = a_idx.device
    lib = library()
    if geo.instance == "ring":
        ent_a, off_a = _packed(m, n_rounds, rmax_a, dev)
        ent_b, off_b = _packed(n, n_rounds, rmax_b, dev)
        ptrs = [t.data_ptr() for t in (ent_a, off_a, ent_b, off_b)]
    else:
        ptrs = [None] * 4
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.index_match_launch(
        int(geo.stripes), INSTANCES.index(geo.instance), a_idx.data_ptr(),
        a_val.data_ptr(), b_idx.data_ptr(), b_val.data_ptr(),
        out.data_ptr(), m, n, n_rounds, rmax_a, rmax_b, rounds, *ptrs,
        geo.rows_per_warp, geo.stages, geo.cap, geo.grid, geo.chunk,
        geo.smem, dev.index, stream)
    raise_on_error(lib, name, err)
    INSTANCE_LAUNCHES[f"{name}/{geo.instance}"] += 1
    return geo


def _resolve_out_dtype(a_val: torch.Tensor, b_val: torch.Tensor,
                       out_dtype: Optional[torch.dtype]) -> torch.dtype:
    if out_dtype is None:
        return torch.promote_types(a_val.dtype, b_val.dtype)
    return out_dtype


def plain(a_idx: torch.Tensor, a_val: torch.Tensor, b_idx: torch.Tensor,
          b_val: torch.Tensor, *, rounds: int = 128, bm: int = 128,
          bn: int = 128, out_dtype: Optional[torch.dtype] = None
          ) -> torch.Tensor:
    """The plain torch version on any device, with the wrapper's checks:
    what the kernel is held against."""
    out_dtype = _resolve_out_dtype(a_val, b_val, out_dtype)
    m, n, n_rounds = check_operands("index_match_spmm", a_idx, a_val, b_idx,
                                    b_val, bm, bn)
    acc = torch.zeros((m, n), dtype=torch.float32, device=a_idx.device)
    for t in range(n_rounds):
        acc = acc + round_partial(a_idx, a_val, b_idx, b_val, t, rounds)
    return acc.to(out_dtype)


def index_match_spmm(a_idx: torch.Tensor, a_val: torch.Tensor,
                     b_idx: torch.Tensor, b_val: torch.Tensor, *,
                     rounds: int = 128, bm: int = 128, bn: int = 128,
                     out_dtype: Optional[torch.dtype] = None,
                     geometry: Optional[MatchGeometry] = None
                     ) -> torch.Tensor:
    """C[M, N] = A[M, K] @ B[N, K].T from per-round padded sparse rows.

    Accumulation is f32 over rounds ascending; the one cast to
    ``out_dtype`` (default: the promoted type of the two value arrays)
    happens at the end. ``geometry`` (a tuned launch or a sweep's)
    overrides ``match_geometry`` on the card; ``analysis.launch_check``
    must pass it on any device, else ``KernelConfigError`` is raised
    before the launch.
    """
    if geometry is not None:
        from ..analysis import launch_check
        m, n_rounds, rmax_a = a_idx.shape
        launch_check.require_launch(
            "index_match_spmm", geometry=geometry, m=m, n=b_idx.shape[0],
            n_rounds=n_rounds, rmax_a=rmax_a, rmax_b=b_idx.shape[2],
            rounds=rounds, on_card=a_idx.device.type == "cuda",
            context=f"index_match_spmm at geometry {tuple(geometry)}")
    if a_idx.device.type == "cpu":
        return plain(a_idx, a_val, b_idx, b_val, rounds=rounds, bm=bm,
                     bn=bn, out_dtype=out_dtype)
    out_dtype = _resolve_out_dtype(a_val, b_val, out_dtype)
    m, n, _ = check_operands("index_match_spmm", a_idx, a_val, b_idx, b_val,
                             bm, bn)
    if a_idx.device.type != "cuda":
        raise ValueError(f"index_match_spmm: no kernel for device "
                         f"{a_idx.device}")
    out = torch.empty((m, n), dtype=torch.float32, device=a_idx.device)
    if launch_match("index_match_spmm", a_idx, a_val, b_idx, b_val, out,
                    rounds, geometry):
        LAUNCHES["index_match_spmm"] += 1
    return out.to(out_dtype)
