"""Launch geometry of the GEMM core that ``csrc/dense_mm.cu`` and
``csrc/bsr_spmm.cu`` share (``csrc/gemm_sm90.cuh``).

The wrappers compute every launch here, in Python, and the C launchers take
it as given, so the CPU tests can pin it: the instance, its tiles, the
number of K splits, the ring's stages and the shared memory. Pure host
arithmetic; nothing here touches a device.

Instances (the ids of each source's ``enum Instance``):

- ``f32_fma``: f32 FMA behind a cp.async ring, 128 x 128 tiles, BK = 16,
  128 threads (8 x 16 outputs a thread), two CTAs an SM;
- ``bf16_wgmma``: wgmma on the tensor cores behind a TMA ring, 128 x 256
  tiles where they fill the card (else 128 x 128), BK = 64, two consumer
  warpgroups and a producer warp, one CTA an SM;
- ``general_f32`` / ``general_bf16``: the kernels for any shape (dense: K
  steps of 8; BSR: chunks of 16 (block, k) pairs).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

INSTANCES = ("f32_fma", "bf16_wgmma", "general_f32", "general_bf16")
FAST = {torch.float32: "f32_fma", torch.bfloat16: "bf16_wgmma"}
GENERAL = {torch.float32: "general_f32", torch.bfloat16: "general_bf16"}

SMS = 132                 # H100 SXM
SMEM_LIMIT = 232_448      # shared memory one block may use (227 KB)
GRID_X_MAX = 2 ** 31 - 1
GRID_Y_MAX = 65_535
TILE_M = TILE_N = 128
BF16_WIDE_N = 256         # the bf16 instance's tile columns where N > 128
TILE_K = {"f32_fma": 16, "bf16_wgmma": 64}
THREADS = {"f32_fma": 128, "bf16_wgmma": 288}
CTAS_PER_SM = {"f32_fma": 2, "bf16_wgmma": 1}   # the kernels' launch bounds
STAGES = {"f32_fma": 2, "bf16_wgmma": 4}
STAGES_RANGE = {"f32_fma": (2, 5), "bf16_wgmma": (2, 4)}
# Elements of a 16-byte row pitch: the fast instances' row alignment.
VECTOR = {torch.float32: 4, torch.bfloat16: 8}
# A split takes at least this many K steps.
MIN_SPLIT_STEPS = 8


class GemmGeometry(NamedTuple):
    instance: str
    tile_m: int
    tile_n: int
    tile_k: int
    splits: int           # K splits: the grid's y (1: no split)
    stages: int           # ring stages (0 for the general instances)
    threads: int
    smem: int             # dynamic shared memory, bytes
    row_tiles: int
    col_tiles: int
    # general BSR instance: (tm, row_threads, col_threads, rows_alloc, bn,
    # n_sub); empty elsewhere
    layout: Tuple[int, ...] = ()

    @property
    def tiles(self) -> int:
        return self.row_tiles * self.col_tiles


def compute_dtype(a: torch.dtype, b: torch.dtype, what: str) -> torch.dtype:
    """The type both operands are promoted to, as the plain versions and
    JAX promote them; f32 and bf16 each have their own instances."""
    dt = torch.promote_types(a, b)
    if dt not in FAST:
        raise TypeError(
            f"{what}: the kernels take f32 or bf16 operands (promoted from "
            f"{a} and {b} to {dt}); other types are not a mode of the port "
            f"(ROADMAP, 'f32 accuracy')")
    return dt


def smem_bytes(instance: str, stages: int, tile_n: int = TILE_N) -> int:
    """Dynamic shared memory of a fast instance (the kernels'
    ``f32_smem_bytes`` / ``bf16_smem_bytes``)."""
    if instance == "f32_fma":      # A^T double buffer + the B ring, f32
        return 4 * (2 * 16 * TILE_M + stages * 16 * TILE_N)
    # 1,024 for the swizzle's alignment, A and B stages, two mbarriers each
    return 1024 + stages * (TILE_M * 64 * 2 + 64 * tile_n * 2) + 16 * stages


def tile_n_for(instance: str, n: int, row_tiles: int) -> int:
    """A fast instance's tile columns. The bf16 instance takes 256 where N
    is wider than 128 and the wide tiles still fill every SM (per flop, a
    wide tile issues half the wgmma instructions, stage waits and A reads;
    measured faster by chip_smoke's plan_geometries); elsewhere, and for
    f32, 128 (a short grid is split over K instead, and the partials of a
    narrower tile cost less to add)."""
    wide = instance == "bf16_wgmma" and n > TILE_N and \
        row_tiles * -(-n // BF16_WIDE_N) >= SMS
    return BF16_WIDE_N if wide else TILE_N


def splits_for(instance: str, tiles: int, steps: float,
               splits: Optional[int] = None) -> int:
    """K splits: where ``tiles`` CTAs under-fill the card, as many splits
    as fill its SMs in whole waves (``CTAS_PER_SM`` a wave each), each of at
    least ``MIN_SPLIT_STEPS`` of the tile's (mean) ``steps``."""
    if splits is not None:
        if not 1 <= splits <= GRID_Y_MAX:
            raise ValueError(f"splits must be in 1..{GRID_Y_MAX}, got "
                             f"{splits}")
        return splits
    slots = SMS * CTAS_PER_SM[instance]
    if tiles <= 0 or tiles * 2 > slots:
        return 1
    return max(1, min(slots // tiles, int(steps // MIN_SPLIT_STEPS)))


def fast_geometry(instance: str, row_tiles: int, n: int, steps: float, *,
                  splits: Optional[int] = None, stages: Optional[int] = None,
                  tile_n: Optional[int] = None) -> GemmGeometry:
    stages = STAGES[instance] if stages is None else stages
    if tile_n is None:
        tile_n = tile_n_for(instance, n, row_tiles)
    elif tile_n not in ((TILE_N, BF16_WIDE_N) if instance == "bf16_wgmma"
                        else (TILE_N,)):
        raise ValueError(f"{instance}: no tile of {tile_n} columns")
    col_tiles = -(-n // tile_n)
    lo, hi = STAGES_RANGE[instance]
    if not lo <= stages <= hi:
        raise ValueError(f"{instance}: stages must be in {lo}..{hi}, got "
                         f"{stages}")
    tiles = row_tiles * col_tiles
    if tiles > GRID_X_MAX:
        raise ValueError(f"{instance}: {tiles} tiles exceed the grid")
    geo = GemmGeometry(instance, TILE_M, tile_n, TILE_K[instance],
                       splits_for(instance, tiles, steps, splits), stages,
                       THREADS[instance], smem_bytes(instance, stages, tile_n),
                       row_tiles, col_tiles)
    check_smem(geo)
    return geo


def check_smem(geo: GemmGeometry) -> None:
    if geo.smem > SMEM_LIMIT:
        raise ValueError(f"{geo.instance}: needs {geo.smem} bytes of shared "
                         f"memory per block, over the card's {SMEM_LIMIT}")


def aligned(*tensors: torch.Tensor) -> bool:
    """Every tensor starts on 16 bytes (what cp.async and TMA read)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def workspace(geo: GemmGeometry, device: torch.device):
    """The split-K partials and tickets of one launch, or (None, None)."""
    if geo.splits == 1:
        return None, None
    ws = torch.empty(geo.splits * geo.tiles * geo.tile_m * geo.tile_n,
                     dtype=torch.float32, device=device)
    tickets = torch.zeros(geo.tiles, dtype=torch.int32, device=device)
    return ws, tickets
