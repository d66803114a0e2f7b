"""Autotuner for the port's InCRS orders and index matching on the H100.

The port of ``repro.kernels.autotune``. A sweep measures each candidate
launch of one prepared operand and RHS width, with the cost model of
``core.mesh_sim`` as its prior: every candidate is predicted, the most
promising ``top_k`` are measured, and the winner records its
``overhead_factor = measured / predicted``. The candidates are each
kernel's own launch knobs (``incrs_spmm.KNOBS``): expand's rows a CTA,
reuse's threads a row (where its panel holds N), pipelined's cluster,
columns a lane and consumer warps; index matching's round window R and
its instance and rows a warp. Each passes ``analysis.launch_check``'s
``LAUNCH_RULES`` before it is measured; a sweep with none raises.

Measurement is phase ``times``' protocol in ``chip_smoke.py``: CUDA
events after a warm-up, L2 flushed before each launch, the median of
``reps``. A CPU tensor times the plain versions on the host clock under
the backend ``"cpu"``, so the protocol is testable without a card; those
numbers are not the card's.

Winners persist in ``~/.cache/repro-torch-autotune.json`` (or the file
``REPRO_TORCH_AUTOTUNE_CACHE`` names), keyed as the JAX package keys
them, with this package's backend (``backend_name``): ``"cuda-sm90"`` on
an H100, ``"cpu"`` for the plain versions. The file is versioned
(``AUTOTUNE_VERSION``) and marked as this package's own; a file of
another version or owner, or unreadable, is ignored, so a JAX cache is
never read. ``ops.spmm(variant="auto")``, ``sparse.plan(tune=)`` and the
serving engine's cost model ride these entries.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import logging
import os
import statistics
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..analysis import launch_check as _lc
from ..core.mesh_sim import (FusedKernelCost, SpGEMMCost, fused_spmm_cost,
                             index_match_cost)
from . import incrs_spmm as _k
from . import index_match_spmm as _im

log = logging.getLogger(__name__)

# Bump on a kernel change that shifts the landscape: every stored entry
# is then ignored.
AUTOTUNE_VERSION = 1
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
OWNER = "repro_torch"

# Candidates measured by a sweep, in cost-model order (None: all).
MEASURE_TOP_K = 8
# Round windows of the matched sweep: the paper's 32, 64 and 128.
MATCHED_ROUNDS: Tuple[int, ...] = (32, 64, 128)
# Rows a warp of index matching's ring tried beside the rule's.
MATCHED_ROWS_PER_WARP: Tuple[int, ...] = (2, 4, 8, 16)
# Pipelined knobs swept (the rule's consumer warps: None).
PIPE_CLUSTERS = (1, 2, 4)
PIPE_WARPS = (None, 8, 16)
FLUSH_FLOATS = 64 * 2 ** 20            # 256 MB: evicts the 50 MB L2

VARIANTS = tuple(_k.ORDERS)


# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One winning launch with its prediction audit trail. ``geometry``
    is what the launcher takes (``incrs_spmm.launch_geometry``'s tuple or
    ``PipeGeometry``, ``index_match_spmm.MatchGeometry``), as a tuple;
    ``rounds`` is the matched family's window (0 for the InCRS orders);
    ``bn`` the column tile N was padded to; ``n_cols`` the RHS width it
    was measured at (0: not recorded)."""
    variant: str
    bm: int
    bn: int
    measured_us: float
    predicted_us: float
    rounds: int = 0
    geometry: Optional[tuple] = None
    n_cols: int = 0

    @property
    def overhead_factor(self) -> float:
        """measured / predicted: how far the card is from the model."""
        if self.predicted_us <= 0:
            return float("inf")
        return self.measured_us / self.predicted_us

    @property
    def launch_geometry(self):
        """``geometry`` as the launcher's own type."""
        g = self.geometry
        if g is None:
            return None
        if self.variant == "pipelined":
            return _k.PipeGeometry(*g)
        if self.variant == "index_match":
            return _im.MatchGeometry(*g)
        return tuple(g)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["geometry"] = None if self.geometry is None else list(self.geometry)
        return d

    @staticmethod
    def from_json(d: dict) -> "TunedConfig":
        g = d.get("geometry")
        return TunedConfig(str(d["variant"]), int(d["bm"]), int(d["bn"]),
                           float(d["measured_us"]), float(d["predicted_us"]),
                           int(d.get("rounds", 0)),
                           None if g is None else tuple(g),
                           int(d.get("n_cols", 0)))


def backend_name(device) -> str:
    """``"cuda-sm<major><minor>"`` for a CUDA device (``"cuda-sm90"`` on
    an H100), ``"cpu"`` for the plain versions."""
    dev = torch.device(device)
    if dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev)
        return f"cuda-sm{major}{minor}"
    return dev.type


def default_backend() -> str:
    """The backend a caller without a device reads entries of: the
    current CUDA device's, else ``"cpu"``."""
    if torch.cuda.is_available():
        return backend_name(torch.device("cuda",
                                         torch.cuda.current_device()))
    return "cpu"


def cache_key(padded_rows: int, n_sections: int, smax: int, section: int,
              n_cols: int, backend: str) -> str:
    """Prepared-operand shape + RHS width + backend, in JAX's format."""
    return (f"m{padded_rows}.sec{n_sections}x{section}.w{smax}"
            f".n{n_cols}.{backend}")


def matched_cache_key(m: int, n: int, k: int, backend: str) -> str:
    """The matched family's key: the logical shape + backend (R is part
    of the result), in JAX's format."""
    return f"im.m{m}.n{n}.k{k}.{backend}"


def parse_cache_key(key: str) -> Optional[dict]:
    """Invert ``cache_key`` into its fields, or None for another key."""
    parts = key.split(".")
    if len(parts) < 5:
        return None
    m_s, sec_s, w_s, n_s = parts[:4]
    try:
        if not (m_s.startswith("m") and sec_s.startswith("sec")
                and w_s.startswith("w") and n_s.startswith("n")):
            return None
        ns_s, section_s = sec_s[3:].split("x")
        return {"padded_rows": int(m_s[1:]), "n_sections": int(ns_s),
                "section": int(section_s), "smax": int(w_s[1:]),
                "n_cols": int(n_s[1:]), "backend": ".".join(parts[4:])}
    except ValueError:
        return None


# ----------------------------------------------------------------------
# The disk cache: versioned, owned, written atomically.
_MEM: Dict[str, TunedConfig] = {}


def cache_path() -> str:
    return os.environ.get(CACHE_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro-torch-autotune.json")


_DISK: Dict[str, tuple] = {}            # path -> (stat, entries)


def _load_disk() -> Dict[str, dict]:
    """The entries of the cache file, re-read only when its stat changes
    (``ops.spmm`` asks on every ``auto`` call)."""
    path = cache_path()
    try:
        st = os.stat(path)
        stamp = (st.st_mtime_ns, st.st_size, st.st_ino)
        hit = _DISK.get(path)
        if hit is not None and hit[0] == stamp:
            return dict(hit[1])
        with open(path) as f:
            blob = json.load(f)
    except (OSError, ValueError):
        return {}
    entries = blob.get("entries") if isinstance(blob, dict) and \
        blob.get("owner") == OWNER and \
        blob.get("version") == AUTOTUNE_VERSION else None
    entries = entries if isinstance(entries, dict) else {}
    _DISK[path] = (stamp, entries)
    return dict(entries)


def _store_disk(key: str, cfg: TunedConfig) -> None:
    path = cache_path()
    entries = _load_disk()
    entries[key] = cfg.to_json()
    payload = {"owner": OWNER, "version": AUTOTUNE_VERSION,
               "entries": entries}
    folder = os.path.dirname(path) or "."
    try:
        os.makedirs(folder, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=folder, prefix=".autotune-")
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, path)          # readers never see a torn file
    except OSError:
        pass                           # read-only: the memory cache holds


def _parse(raw) -> Optional[TunedConfig]:
    if not isinstance(raw, dict):
        return None
    try:
        return TunedConfig.from_json(raw)
    except (KeyError, TypeError, ValueError):
        return None


def lookup(key: str) -> Optional[TunedConfig]:
    """Memory first, then disk (a hit is kept in memory)."""
    hit = _MEM.get(key)
    if hit is not None:
        return hit
    cfg = _parse(_load_disk().get(key))
    if cfg is not None:
        _MEM[key] = cfg
    return cfg


def cached_configs() -> Dict[str, TunedConfig]:
    """Every entry, disk merged under memory, by key."""
    out = {}
    for key, raw in _load_disk().items():
        cfg = _parse(raw)
        if cfg is not None:
            out[key] = cfg
    out.update(_MEM)
    return out


def clear_memory_cache() -> None:
    """Forget in-process tuning state (the disk is untouched)."""
    _MEM.clear()
    _DISK.clear()
    _logged.clear()


# ----------------------------------------------------------------------
# The cost-model prior.
def kernel_cost(variant: str, m: int, n: int, *, n_sections: int,
                smax: int, section: int, bm: int = 128, bn: int = 128,
                nnz: Optional[int] = None, geometry=None) -> FusedKernelCost:
    """The cost breakdown of one launch (``mesh_sim.fused_spmm_cost``)."""
    return fused_spmm_cost(variant, m, n, n_sections=n_sections, smax=smax,
                           section=section, bm=bm, bn=bn, nnz=nnz,
                           geometry=geometry)


def predict_us(variant: str, m: int, n: int, *, n_sections: int, smax: int,
               section: int, bm: int = 128, bn: int = 128,
               geometry=None) -> float:
    """Predicted µs of one launch on the card from the cost model."""
    return kernel_cost(variant, m, n, n_sections=n_sections, smax=smax,
                       section=section, bm=bm, bn=bn,
                       geometry=geometry).predicted_us


def predict_matched_us(m: int, n: int, *, rounds: int, n_rounds: int,
                       rmax_a: int, rmax_b: int, geometry=None) -> float:
    """Predicted µs of one index-matching launch."""
    return index_match_cost(m, n, rounds=rounds, n_rounds=n_rounds,
                            rmax_a=rmax_a, rmax_b=rmax_b,
                            geometry=geometry).predicted_us


_logged: set = set()


def pick_spgemm_engine(cost: SpGEMMCost) -> str:
    """The SpGEMM ``auto`` pick: the engine of least predicted time on the
    card, with a one-time log line per cost signature."""
    us = cost.predicted_us()
    pick = min(us, key=us.get)
    sig = ("spgemm", cost.fused.ctas, cost.fused.hbm_bytes,
           cost.densify.hbm_bytes)
    if sig not in _logged:
        _logged.add(sig)
        log.info("spmm auto (sparse RHS): picked %r (predicted µs: "
                 "reference=%.1f condense_merge=%.1f densify=%.1f)", pick,
                 us["reference"], us["condense_merge"], us["densify"])
    return pick


def model_pick_variant(m: int, n: int, *, n_sections: int, smax: int,
                       section: int, bm: int = 128, bn: int = 128) -> str:
    """The InCRS order of least predicted time among those whose own
    geometry passes ``LAUNCH_RULES`` at these shapes (no measurement),
    with a one-time log line. A pure function of the shapes and of what
    the check can see, memoized (``ops.spmm``'s ``auto`` asks on every
    call without a tuned entry). Raises ``KernelConfigError`` where no
    order passes."""
    pick, scored = _model_scores(m, n, n_sections, smax, section, bm, bn)
    sig = (m, n, n_sections, smax, section)
    if sig not in _logged:
        _logged.add(sig)
        log.info("spmm auto (no tuned entry): picked %r for m=%d n=%d "
                 "(predicted µs: %s)", pick, m, n,
                 ", ".join(f"{v}={u:.1f}" for v, u in sorted(scored.items())))
    return pick


@functools.lru_cache(maxsize=1024)
def _model_scores(m: int, n: int, n_sections: int, smax: int, section: int,
                  bm: int, bn: int) -> Tuple[str, Dict[str, float]]:
    allowed, first = [], []
    for v in VARIANTS:
        vs = _lc.check_incrs_config(v, m=m, n=n, n_sections=n_sections,
                                    smax=smax, section=section)
        if vs:
            first.append(vs[0])
        else:
            allowed.append(v)
    if not allowed:
        raise _lc.KernelConfigError(
            first, context=f"spmm auto: no InCRS order launches at m={m} "
            f"n={n} stripes ({n_sections}, {smax})")
    scored = {v: predict_us(v, m, n, n_sections=n_sections, smax=smax,
                            section=section, bm=bm, bn=bn)
              for v in allowed}
    return min(scored, key=scored.get), scored


# ----------------------------------------------------------------------
# The sweep space.
def candidate_space(padded_rows: int, n: int, *, smax: int, section: int
                    ) -> List[Tuple[str, dict]]:
    """The raw ``(variant, knobs)`` of one problem at N (padded) columns,
    before the launch check: expand at each rows a CTA, reuse at each
    threads a row whose panel holds N (else the widest), pipelined at each
    cluster, columns a lane and consumer warps."""
    out = [("expand", {"rows": r}) for r in _k.EXPAND_ROWS]
    tprs = [t for t in _k.REUSE_TPR if _k.REUSE_COLS_PER_THREAD * t >= n] \
        or [_k.REUSE_TPR[-1]]
    out += [("reuse", {"tpr": t}) for t in tprs]
    out += [("pipelined", {"cluster": c, "cols_per_lane": cpl, **(
        {} if w is None else {"warps": w})})
        for c in PIPE_CLUSTERS for cpl in _k.PIPE_CPL for w in PIPE_WARPS]
    return out


def split_candidates(padded_rows: int, n: int, *, section: int,
                     n_sections: int, smax: int
                     ) -> Tuple[List[Tuple[str, tuple]], List[dict]]:
    """The sweep space as (feasible, skipped): each candidate's geometry
    (distinct ones only) held against ``LAUNCH_RULES``; a skip records
    the first rule it broke."""
    feasible, skipped, seen = [], [], set()
    for variant, knobs in candidate_space(padded_rows, n, smax=smax,
                                          section=section):
        try:
            geo = _k.launch_geometry(_k.ORDERS[variant], n, smax, section,
                                     m=padded_rows, **knobs)
        except ValueError as err:
            v = _lc.refusal(_k.ORDERS[variant], err)
            skipped.append({"variant": variant, "knobs": knobs,
                            "rule": v.rule, "message": v.message})
            continue
        if (variant, tuple(geo)) in seen:
            continue
        seen.add((variant, tuple(geo)))
        vs = _lc.check_incrs_config(variant, m=padded_rows, n=n,
                                    n_sections=n_sections, smax=smax,
                                    section=section, geometry=geo)
        if vs:
            skipped.append({"variant": variant, "knobs": knobs,
                            "geometry": list(geo), "rule": vs[0].rule,
                            "message": vs[0].message})
        else:
            feasible.append((variant, geo))
    return feasible, skipped


def candidates(padded_rows: int, n: int, *, section: int, n_sections: int,
               smax: int) -> List[Tuple[str, tuple]]:
    """The feasible ``(variant, geometry)`` of one problem."""
    return split_candidates(padded_rows, n, section=section,
                            n_sections=n_sections, smax=smax)[0]


# ----------------------------------------------------------------------
def _measure_us(fn: Callable[[], torch.Tensor], reps: int,
                device: torch.device,
                flush: Optional[torch.Tensor]) -> float:
    """Median µs of ``fn``: CUDA events after 3 warm-up runs, L2 flushed
    before each run (``flush``), on a CUDA device; the host clock after
    one warm-up on the CPU."""
    reps = max(1, reps)
    if device.type != "cuda":
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        return statistics.median(times)
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize(device)
    return statistics.median(s.elapsed_time(e) for s, e in pairs) * 1e3


def _flush_buffer(device: torch.device) -> Optional[torch.Tensor]:
    if device.type != "cuda":
        return None
    return torch.empty(FLUSH_FLOATS, device=device)


@dataclasses.dataclass
class SweepRecord:
    """What one sweep considered, skipped (and why), measured, and
    picked."""
    key: str
    cache_hit: bool
    n_candidates: int
    skipped_infeasible: List[dict]
    measured: List[dict]
    elapsed_s: float
    winner: Optional[TunedConfig]

    def to_json(self) -> dict:
        return {"key": self.key, "cache_hit": self.cache_hit,
                "n_candidates": self.n_candidates,
                "skipped_infeasible": self.skipped_infeasible,
                "measured": self.measured, "elapsed_s": self.elapsed_s,
                "winner": self.winner.to_json() if self.winner else None}


LAST_SWEEP: Optional[SweepRecord] = None


def _no_candidate(key: str, skipped: List[dict]):
    return _lc.KernelConfigError(
        [_lc.Violation(s["rule"], s["message"]) for s in skipped[:3]],
        context=f"autotune {key}: no candidate passes the launch check")


def tune(idx: torch.Tensor, val: torch.Tensor, b: torch.Tensor, *,
         section: int, reps: int = 10, persist: bool = True,
         top_k: Optional[int] = MEASURE_TOP_K,
         verify: Optional[Callable[[str, tuple, torch.Tensor], None]] = None
         ) -> TunedConfig:
    """Sweep the InCRS orders' launches for prepared stripes ``(idx,
    val)`` (rows padded) times ``b`` (K or n_sections * section rows, N
    columns), on their device.

    A cache hit returns the stored config without running anything.
    Otherwise the candidates that pass the launch check are ranked by the
    cost model, the ``top_k`` first (None: all) are measured on B padded
    as ``ops.spmm`` pads it, the fastest is kept in memory and (with
    ``persist``) on disk. ``verify(variant, geometry, C)`` sees each
    measured candidate's output. Raises ``KernelConfigError`` where no
    candidate passes."""
    global LAST_SWEEP
    from . import ops                       # circular at module scope
    t0 = time.perf_counter()
    device = idx.device
    m, n_sections, smax = idx.shape
    n = b.shape[1]
    key = cache_key(m, n_sections, smax, section, n, backend_name(device))
    hit = lookup(key)
    if hit is not None:
        LAST_SWEEP = SweepRecord(key, True, 0, [], [],
                                 time.perf_counter() - t0, hit)
        return hit
    bn = ops.default_bn(n)
    np_ = -(-n // bn) * bn
    mp = _k._resolve_row_tile(m, 128)[1]        # as ops.spmm launches
    kp = n_sections * section
    bp = torch.nn.functional.pad(b.to(device, torch.float32),
                                 (0, np_ - n, 0, kp - b.shape[0]))
    bp = bp.contiguous()
    cands, skipped = split_candidates(mp, np_, section=section,
                                      n_sections=n_sections, smax=smax)
    if not cands:
        raise _no_candidate(key, skipped)
    predicted = {(v, tuple(g)): predict_us(v, mp, np_,
                                           n_sections=n_sections,
                                           smax=smax, section=section,
                                           geometry=g)
                 for v, g in cands}
    ranked = sorted(cands, key=lambda c: predicted[(c[0], tuple(c[1]))])
    flush = _flush_buffer(device)
    best, measured = None, []
    for variant, geo in ranked[:top_k]:
        kernel = ops._INCRS_KERNELS[variant]

        def run(kernel=kernel, geo=geo):
            return kernel(idx, val, bp, section=section, bm=128, bn=bn,
                          geometry=geo)
        if verify is not None:
            verify(variant, geo, run())
        us = _measure_us(run, reps, device, flush)
        pred = predicted[(variant, tuple(geo))]
        measured.append({"variant": variant, "geometry": list(geo),
                         "us": us, "predicted_us": pred})
        cfg = TunedConfig(variant, 128, bn, us, pred, 0, tuple(geo), n)
        if best is None or us < best.measured_us:
            best = cfg
    _MEM[key] = best
    LAST_SWEEP = SweepRecord(key, False, len(cands) + len(skipped), skipped,
                             measured, time.perf_counter() - t0, best)
    if persist:
        _store_disk(key, best)
    log.info("autotune: %s -> %s %s (measured %.1fµs, predicted %.1fµs, "
             "overhead %.2fx)", key, best.variant, best.geometry,
             best.measured_us, best.predicted_us, best.overhead_factor)
    return best


def _matched_candidates(m: int, n: int, n_rounds: int, rmax: int,
                        rounds: int) -> List[tuple]:
    """Index matching's geometries at one window: the rule's, the ring at
    each of ``MATCHED_ROWS_PER_WARP`` rows a warp, the general instance;
    distinct ones, each as the wrapper builds it (a refusal is left out:
    the check reports it on the rule's)."""
    out = []
    for kw in ({}, *({"instance": "ring", "rows_per_warp": r}
                     for r in MATCHED_ROWS_PER_WARP),
               {"instance": "general"}):
        try:
            g = _im.match_geometry(m, n, n_rounds, rmax, rmax, rounds, **kw)
        except ValueError:
            continue
        if g not in out:
            out.append(g)
    return out


def tune_index_match(a, bt, *, device=None, reps: int = 10,
                     persist: bool = True,
                     top_k: Optional[int] = MEASURE_TOP_K,
                     rounds_options: Sequence[int] = MATCHED_ROUNDS,
                     verify: Optional[Callable[[int, tuple, torch.Tensor],
                                               None]] = None
                     ) -> TunedConfig:
    """Sweep index matching's round window and geometry for CRS ``a`` @
    ``bt``.T on ``device`` (default CUDA): the same protocol as ``tune``,
    the operands prepped per window (rows padded to 128). The winner's
    window lands in ``TunedConfig.rounds`` and its launch in
    ``geometry``; ``ops.spmm`` rides them at this shape."""
    global LAST_SWEEP
    from . import ops                       # circular at module scope
    t0 = time.perf_counter()
    dev = ops.resolve_device(device)
    m, k = a.shape
    n = bt.shape[0]
    key = matched_cache_key(m, n, k, backend_name(dev))
    hit = lookup(key)
    if hit is not None:
        LAST_SWEEP = SweepRecord(key, True, 0, [], [],
                                 time.perf_counter() - t0, hit)
        return hit
    cands, skipped, preps = [], [], {}
    for r in rounds_options:
        ai, av = ops.prep_rounds(a, r, pad_rows_to=128, device=dev)
        bi, bv = ops.prep_rounds(bt, r, pad_rows_to=128, device=dev)
        ai, av, bi, bv = ops.pad_common_rmax(ai, av, bi, bv)
        preps[r] = (ai, av, bi, bv)
        mp, n_rounds, rmax = ai.shape
        np_ = bi.shape[0]
        for g in _matched_candidates(mp, np_, n_rounds, rmax, r):
            vs = _lc.check_matched_config(
                "index_match", m=mp, n=np_, n_rounds=n_rounds, rmax_a=rmax,
                rmax_b=rmax, rounds=r, geometry=g)
            if vs:
                skipped.append({"rounds": r, "geometry": list(g),
                                "rule": vs[0].rule,
                                "message": vs[0].message})
            else:
                cands.append((r, g, predict_matched_us(
                    mp, np_, rounds=r, n_rounds=n_rounds, rmax_a=rmax,
                    rmax_b=rmax, geometry=g)))
    if not cands:
        raise _no_candidate(key, skipped)
    cands.sort(key=lambda c: c[2])
    flush = _flush_buffer(dev)
    best, measured = None, []
    for r, g, pred in cands[:top_k]:
        ai, av, bi, bv = preps[r]

        def run(r=r, g=g, ai=ai, av=av, bi=bi, bv=bv):
            return _im.index_match_spmm(ai, av, bi, bv, rounds=r, bm=128,
                                        bn=128, geometry=g)
        if verify is not None:
            verify(r, g, run())
        us = _measure_us(run, reps, dev, flush)
        measured.append({"rounds": r, "geometry": list(g), "us": us,
                         "predicted_us": pred})
        cfg = TunedConfig("index_match", 128, 128, us, pred, r, tuple(g),
                          n)
        if best is None or us < best.measured_us:
            best = cfg
    _MEM[key] = best
    LAST_SWEEP = SweepRecord(key, False, len(cands) + len(skipped), skipped,
                             measured, time.perf_counter() - t0, best)
    if persist:
        _store_disk(key, best)
    log.info("autotune: %s -> R=%d %s (measured %.1fµs, predicted %.1fµs, "
             "overhead %.2fx)", key, best.rounds, best.geometry,
             best.measured_us, best.predicted_us, best.overhead_factor)
    return best


__all__ = ["AUTOTUNE_VERSION", "CACHE_ENV", "TunedConfig", "SweepRecord",
           "LAST_SWEEP", "backend_name", "default_backend", "cache_key",
           "matched_cache_key", "parse_cache_key", "cache_path", "lookup",
           "cached_configs", "clear_memory_cache", "kernel_cost",
           "predict_us", "predict_matched_us", "pick_spgemm_engine",
           "model_pick_variant", "candidate_space", "split_candidates",
           "candidates", "tune", "tune_index_match", "MEASURE_TOP_K"]
