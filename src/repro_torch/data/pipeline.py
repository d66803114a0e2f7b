"""Token data pipeline: deterministic synthesis, prefetch, straggler guard.

The port's own copy of ``repro.data.pipeline`` (numpy and threads, no
torch): the same batches, bit for bit, for every (seed, step, rank,
world); the train loop moves them to its device.

  * ``SyntheticTokens`` — deterministic per (seed, step, rank) batches, so
    restarts and elastic rescales reproduce the same stream (rank r of R
    reads global-batch slice [r·B/R, (r+1)·B/R): per-rank sharding).
  * ``Prefetcher``      — background thread + bounded queue; ``next()``
    waits up to ``timeout_s`` and then falls back to a deterministic
    filler batch (straggler mitigation: a slow storage shard never stalls
    the whole step; the skipped batch is logged and re-queued).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticTokens:
    """Zipf-ish token stream with shifted labels (next-token objective)."""

    def __init__(self, vocab: int, batch: int, seq: int, *, seed: int = 0,
                 rank: int = 0, world: int = 1, n_prefix: int = 0,
                 d_model: int = 0):
        if batch % world != 0:
            raise ValueError(
                f"global batch {batch} not divisible by world {world}")
        self.vocab, self.seq = vocab, seq
        self.local_batch = batch // world
        self.rank, self.world, self.seed = rank, world, seed
        self.n_prefix, self.d_model = n_prefix, d_model
        self.step = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.rank)
        # Zipf-flavored marginals, cheap: squared uniform
        u = rng.random((self.local_batch, self.seq + 1))
        toks = (u * u * self.vocab).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.n_prefix:
            out["prefix_embeds"] = rng.standard_normal(
                (self.local_batch, self.n_prefix, self.d_model),
                dtype=np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(self.step)
            self.step += 1


class Prefetcher:
    """Bounded background prefetch with straggler fallback."""

    def __init__(self, it: Iterator, depth: int = 2,
                 timeout_s: Optional[float] = None,
                 fallback=None):
        self._it = iter(it)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.timeout_s = timeout_s
        self.fallback = fallback
        self.timeouts = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                while True:
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        if self._stop.is_set():
                            return
        except StopIteration:
            pass
        self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            item = self._q.get(timeout=self.timeout_s)
        except queue.Empty:
            # straggler: upstream too slow -> deterministic filler
            self.timeouts += 1
            if self.fallback is not None:
                return self.fallback(self.timeouts)
            raise TimeoutError("data pipeline stalled and no fallback set")
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
