"""Condense/merge SpGEMM kernels: sparse × sparse through round stripes.

The port of ``repro.spgemm.kernels``. The fused ``index_match_spmm`` adds
each round's partial product into an accumulator; SpGEMM splits that into
two passes:

  condense  S[t, i, j] = the round-t partial p(i, j, t), every (i, j, t)
            independent, into an f32 (n_rounds, M, N) stripe array;
  merge     C = sum of S[t] over t ascending, f32, one cast at the end.

Both reach the CUDA kernels written by hand for Hopper in
``kernels/csrc/index_match.cu``. Condense runs in the instance that
``index_match_spmm.match_geometry`` picks (the ring, its (tile, round)
items spread over the CTAs, or the general kernel) and computes p with
the same device function as the fused kernel of that instance, and merge
adds the rounds in the fused kernel's order, so condense + merge equals
``index_match_spmm`` bit for bit on identically prepped operands, the JAX
contract. The plain versions keep
the same property on the CPU: plain condense stores the plain per-round
partials, and plain merge adds them as the plain fused version does.

Merge runs in the instance that ``merge_geometry`` picks, the one source
of its launch: ``ring`` (a persistent grid of two CTAs an SM, each
owning contiguous chunks of the plane, round t's chunk streamed into a
ring of shared-memory stages by bulk copies) wherever the plane and the
stripes sit on 16 bytes, and ``general`` (the first design, a float4
stream) for the rest. Both add the rounds in the same order, so they
agree bit for bit.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises. ``LAUNCHES`` counts each kernel's launches,
``MERGE_INSTANCE_LAUNCHES`` each merge instance's.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, NamedTuple, Optional

import torch

from ..kernels import _alloc
from ..kernels import index_match_spmm as _im
from ..kernels.incrs_spmm import CTA_RESERVED, SM_SMEM

LAUNCHES: Dict[str, int] = {"spgemm_condense": 0, "spgemm_merge": 0}
# The ids of index_match.cu's enum Instance that merge takes.
MERGE_INSTANCES = ("general", "ring")
MERGE_INSTANCE_LAUNCHES: Dict[str, int] = {f"spgemm_merge/{i}": 0
                                           for i in MERGE_INSTANCES}

# general: merge_kernel, 256 threads of 4 elements, a grid-stride grid of
# at most 132 x 64 blocks.
MERGE_GENERAL_THREADS, MERGE_GENERAL_MAX_GRID = 256, 132 * 64
# ring: merge_ring_kernel, 8 consumer warps and a producer warp; a
# consumer thread holds 8 float4 of a chunk, so a chunk is at most 8,192
# floats. The rule runs two CTAs an SM, 4 stages of chunks of 2 to 6 K
# floats (at most 96 KB a CTA), each a multiple of 1,024 floats: on the
# H100, chunks of 1 K or 8 K floats, or one CTA an SM, ran 1-5 % slower
# (chip_smoke.py, spgemm_geometries; PERF.md).
MERGE_WARPS = 8
MERGE_THREADS = (MERGE_WARPS + 1) * 32
MERGE_MAX_CHUNK = 8 * 4 * MERGE_WARPS * 32
MERGE_CHUNKS = (2048, 3072, 4096, 5120, 6144)   # the rule's candidates
MERGE_CTAS_PER_SM = 2
MERGE_STAGES = 4                          # the rule's ring depth
MERGE_STAGES_RANGE = (2, 12)


class MergeGeometry(NamedTuple):
    """One launch of merge. ring: ``items`` chunks of ``chunk`` floats of
    the plane (the last shorter) walked by ``grid`` persistent CTAs of
    ``threads`` (one wave: two an SM, one where two do not fit), through
    ``stages`` stages, ``smem`` bytes; general: a grid-stride grid of
    ``grid`` blocks, the ring fields 0."""
    instance: str
    chunk: int
    stages: int
    items: int
    grid: int
    threads: int
    smem: int


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for name in MERGE_INSTANCE_LAUNCHES:
        MERGE_INSTANCE_LAUNCHES[name] = 0


def merge_ctas(smem: int) -> int:
    """merge_ring_kernel's CTAs an SM at ``smem`` bytes, as the rule
    counts them: two, or what the SM's shared memory holds (1 KB reserved
    a CTA)."""
    return min(MERGE_CTAS_PER_SM, SM_SMEM // (smem + CTA_RESERVED))


def merge_smem(chunk: int, stages: int) -> int:
    """merge_ring_kernel's shared memory: ``stages`` stages of ``chunk``
    f32 and two mbarriers a stage."""
    return stages * (chunk * 4 + 16)


@lru_cache(maxsize=256)
def merge_geometry(plane: int, n_rounds: int, aligned: bool = True, *,
                   instance: Optional[str] = None,
                   chunk: Optional[int] = None,
                   stages: Optional[int] = None) -> MergeGeometry:
    """The launch of merge on ``n_rounds`` stripes of ``plane`` (= M x N)
    floats: the ring instance wherever ``plane`` is a multiple of 4 and
    the stripes and C sit on 16 bytes (``aligned``), else the general one.
    The rule takes the chunk of ``MERGE_CHUNKS`` whose items give the
    busiest of the 2 x 132 CTAs the fewest floats (ties: the larger
    chunk), ``MERGE_STAGES`` deep. ``instance``,
    ``chunk`` (floats an item) and ``stages`` override the rule
    (sweeps). Raises ValueError where no instance takes the shape."""
    if instance not in (None,) + MERGE_INSTANCES:
        raise ValueError(f"merge_geometry: unknown instance {instance!r}")
    if plane < 1 or not 0 <= n_rounds < 2 ** 31:
        raise ValueError(f"merge_geometry: plane {plane}, {n_rounds} rounds "
                         f"outside the kernels' range")
    if (instance != "general" and aligned and plane % 4 == 0 and
            n_rounds >= 1):
        lo, hi = MERGE_STAGES_RANGE
        depth = stages or MERGE_STAGES
        if not lo <= depth <= hi:
            raise ValueError(f"merge_geometry: stages {depth} outside "
                             f"{lo}..{hi}")
        if chunk is None:
            slots = _im.SMS * MERGE_CTAS_PER_SM

            def busiest(c):        # floats of the CTA with the most items
                items = -(-plane // c)
                return -(-items // slots) * c
            chunk = min(reversed(MERGE_CHUNKS), key=busiest)
        if not (4 <= chunk <= MERGE_MAX_CHUNK and chunk % 4 == 0):
            raise ValueError(f"merge_geometry: chunk {chunk} must be a "
                             f"multiple of 4 in 4..{MERGE_MAX_CHUNK}")
        smem = merge_smem(chunk, depth)
        if smem > _im.SMEM_LIMIT:
            raise ValueError(f"merge_geometry: {depth} stages of {chunk} "
                             f"floats need {smem} bytes of shared memory, "
                             f"over the card's {_im.SMEM_LIMIT}")
        items = -(-plane // chunk)
        ctas = merge_ctas(smem)
        return MergeGeometry("ring", chunk, depth, items,
                             min(items, _im.SMS * ctas), MERGE_THREADS, smem)
    if instance == "ring":
        raise ValueError(f"merge_geometry: the ring instance needs a plane "
                         f"that is a multiple of 4, stripes on 16 bytes and "
                         f"a round (plane {plane}, aligned {aligned}, "
                         f"{n_rounds} rounds)")
    groups = -(-plane // 4)                  # 4 elements a thread
    blocks = -(-groups // MERGE_GENERAL_THREADS)
    return MergeGeometry("general", 0, 0, 0,
                         min(blocks, MERGE_GENERAL_MAX_GRID),
                         MERGE_GENERAL_THREADS, 0)


def merge_ctas_per_sm(geo: MergeGeometry) -> int:
    """The CTAs of ``geo``'s instance that one SM of the current card
    holds, from the card's occupancy calculator."""
    lib = _im.library()
    out = ctypes.c_int(0)
    err = lib.spgemm_merge_ctas_per_sm(MERGE_INSTANCES.index(geo.instance),
                                       geo.smem, ctypes.byref(out))
    _im.raise_on_error(lib, "spgemm_merge_ctas_per_sm", err)
    return out.value


def _check_stripes(stripes: torch.Tensor, bm: int, bn: int) -> None:
    if stripes.ndim != 3:
        raise ValueError(f"stripes must be (n_rounds, M, N), got "
                         f"{tuple(stripes.shape)}")
    _, m, n = stripes.shape
    if m % bm or n % bn:
        raise ValueError(f"stripe shape {(m, n)} must align to tiles "
                         f"{(bm, bn)}")


def plain_condense(a_idx: torch.Tensor, a_val: torch.Tensor,
                   b_idx: torch.Tensor, b_val: torch.Tensor, *,
                   rounds: int = 128, bm: int = 128,
                   bn: int = 128) -> torch.Tensor:
    """The plain torch version of ``spgemm_condense`` on any device."""
    m, n, n_rounds = _im.check_operands("spgemm_condense", a_idx, a_val,
                                        b_idx, b_val, bm, bn)
    out = torch.empty((n_rounds, m, n), dtype=torch.float32,
                      device=a_idx.device)
    for t in range(n_rounds):
        out[t] = _im.round_partial(a_idx, a_val, b_idx, b_val, t, rounds)
    return out


def plain_merge(stripes: torch.Tensor, *, bm: int = 128, bn: int = 128,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain torch version of ``spgemm_merge`` on any device."""
    _check_stripes(stripes, bm, bn)
    acc = torch.zeros(stripes.shape[1:], dtype=torch.float32,
                      device=stripes.device)
    for t in range(stripes.shape[0]):
        acc = acc + stripes[t]
    return acc.to(out_dtype)


def spgemm_condense(a_idx: torch.Tensor, a_val: torch.Tensor,
                    b_idx: torch.Tensor, b_val: torch.Tensor, *,
                    rounds: int = 128, bm: int = 128, bn: int = 128,
                    geometry: Optional[_im.MatchGeometry] = None
                    ) -> torch.Tensor:
    """Partial stripes S[n_rounds, M, N] f32: S[t] = A_t @ B_t.T per round.

    Summing over the first axis in ascending order (``spgemm_merge``)
    gives C = A @ B.T. The array is indexed with 64-bit offsets: it may
    exceed 2**31 elements. ``geometry`` overrides
    ``index_match_spmm.match_geometry`` on the card (sweeps).
    """
    if a_idx.device.type == "cpu":
        return plain_condense(a_idx, a_val, b_idx, b_val, rounds=rounds,
                              bm=bm, bn=bn)
    m, n, n_rounds = _im.check_operands("spgemm_condense", a_idx, a_val,
                                        b_idx, b_val, bm, bn)
    if a_idx.device.type != "cuda":
        raise ValueError(f"spgemm_condense: no kernel for device "
                         f"{a_idx.device}")
    out = _alloc.empty((n_rounds, m, n), torch.float32, a_idx.device)
    if _im.launch_match("spgemm_condense", a_idx, a_val, b_idx, b_val, out,
                        rounds, geometry):
        LAUNCHES["spgemm_condense"] += 1
    return out


def spgemm_merge(stripes: torch.Tensor, *, bm: int = 128, bn: int = 128,
                 out_dtype: torch.dtype = torch.float32,
                 geometry: Optional[MergeGeometry] = None) -> torch.Tensor:
    """C[M, N] = sum_t S[t] in ascending round order, f32, with the one
    cast to ``out_dtype`` at the end. ``geometry`` overrides
    ``merge_geometry`` on the card (sweeps)."""
    if stripes.device.type == "cpu":
        return plain_merge(stripes, bm=bm, bn=bn, out_dtype=out_dtype)
    _check_stripes(stripes, bm, bn)
    if stripes.device.type != "cuda":
        raise ValueError(f"spgemm_merge: no kernel for device "
                         f"{stripes.device}")
    if stripes.dtype != torch.float32:
        raise TypeError(f"spgemm_merge: stripes must be float32, got "
                        f"{stripes.dtype}")
    if not stripes.is_contiguous():
        raise ValueError("spgemm_merge: stripes must be contiguous")
    n_rounds, m, n = stripes.shape
    out = _alloc.empty((m, n), torch.float32, stripes.device)
    if out.numel() == 0:
        return out.to(out_dtype)
    aligned = (stripes.data_ptr() | out.data_ptr()) % 16 == 0
    geo = geometry or merge_geometry(m * n, n_rounds, aligned)
    if geo.instance == "ring" and not aligned:
        raise ValueError("spgemm_merge: the ring instance needs the stripes "
                         "on 16 bytes")
    lib = _im.library()
    stream = torch.cuda.current_stream(stripes.device).cuda_stream
    err = lib.spgemm_merge(MERGE_INSTANCES.index(geo.instance),
                           stripes.data_ptr(), out.data_ptr(), m * n,
                           n_rounds, geo.chunk, geo.stages, geo.grid,
                           geo.smem, stripes.device.index, stream)
    _im.raise_on_error(lib, "spgemm_merge", err)
    LAUNCHES["spgemm_merge"] += 1
    MERGE_INSTANCE_LAUNCHES[f"spgemm_merge/{geo.instance}"] += 1
    return out.to(out_dtype)
