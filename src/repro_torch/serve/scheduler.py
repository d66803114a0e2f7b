"""Cost-model wave packing for the continuous SpMM serving engine.

The port of ``repro.serve.scheduler``, unchanged in logic:

* :class:`WaveCostModel` — an affine per-launch wall-time estimate
  ``us(cols) = launch_overhead_us + us_per_col * cols``, seeded from a
  bench record taken on the card (``seed_from_bench``: the InCRS kernel
  alone at each wave width, ``benchmarks/serve_bench.py``), then refined
  online by an EWMA over every retired wave. Without such a record it
  starts unseeded and the first retired wave seeds it.
* :class:`WavePacker` — turns a latency budget into a wave width through
  the cost model and packs the queue up to that width with a bounded
  skip-scan (at most ``skip_limit`` non-fitting requests bypassed per
  wave, original order preserved).

Both see only objects with a ``b.shape[1]`` column count.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Deque, List, Optional, Sequence, Tuple

# Requests narrower than this never make the target smaller.
MIN_TARGET_COLS = 8

# Default bound on how many queued requests one wave may bypass.
DEFAULT_SKIP_LIMIT = 8

# EWMA weight of a fresh observation (higher = adapt faster, noisier).
DEFAULT_EWMA = 0.25


def fit_us_per_col(pairs: Sequence[Tuple[int, float]]
                   ) -> Tuple[Optional[float], float]:
    """Fit ``us(cols) = overhead + slope * cols`` to measured ``(cols, us)``
    points. Returns ``(us_per_col, launch_overhead_us)``; ``(None, 0.0)``
    when nothing usable was given. One point pins the slope through the
    origin; two or more get a least-squares line with the intercept
    clamped to >= 0 (a non-increasing fit falls back to the through-origin
    estimate of the widest point)."""
    pts = [(int(c), float(u)) for c, u in pairs if c > 0 and u > 0]
    if not pts:
        return None, 0.0
    if len(pts) == 1:
        c, u = pts[0]
        return u / c, 0.0
    n = len(pts)
    mx = sum(c for c, _ in pts) / n
    my = sum(u for _, u in pts) / n
    sxx = sum((c - mx) ** 2 for c, _ in pts)
    sxy = sum((c - mx) * (u - my) for c, u in pts)
    if sxx <= 0 or sxy <= 0:
        c, u = max(pts)
        return u / c, 0.0
    slope = sxy / sxx
    intercept = max(0.0, my - slope * mx)
    return slope, intercept


@dataclasses.dataclass
class WaveCostModel:
    """Affine launch-cost estimate, seeded offline and refined online.
    ``us_per_col`` is None until a seed or the first observed wave gives
    one; callers then use the hard cap."""
    us_per_col: Optional[float] = None
    launch_overhead_us: float = 0.0
    ewma: float = DEFAULT_EWMA
    n_observed: int = 0
    source: str = "unseeded"

    def predict_us(self, cols: int) -> Optional[float]:
        """Predicted wall µs of one ``cols``-wide wave (None = no data)."""
        if self.us_per_col is None:
            return None
        return self.launch_overhead_us + self.us_per_col * max(0, cols)

    def target_cols(self, budget_us: Optional[float], hard_cap: int) -> int:
        """The widest wave predicted to finish inside ``budget_us``,
        clamped to ``[MIN_TARGET_COLS, hard_cap]``."""
        if budget_us is None or self.us_per_col is None \
                or self.us_per_col <= 0:
            return hard_cap
        fit = int((budget_us - self.launch_overhead_us) / self.us_per_col)
        return max(MIN_TARGET_COLS, min(hard_cap, fit))

    def observe(self, cols: int, wall_us: float) -> None:
        """Fold one retired wave's measured wall time into the estimate."""
        if cols <= 0 or wall_us <= 0:
            return
        obs = max(0.0, wall_us - self.launch_overhead_us) / cols
        if obs <= 0:
            return
        if self.us_per_col is None:
            self.us_per_col = obs
        else:
            self.us_per_col = (1.0 - self.ewma) * self.us_per_col \
                + self.ewma * obs
        self.n_observed += 1


# ----------------------------------------------------------------------
# Offline seeds: the measurements the repo persists.
def seed_from_bench(path: str, platform: Optional[str] = None
                    ) -> WaveCostModel:
    """Seed a cost model from a bench record (JAX's row contract): rows
    named ``incrs_spmm*`` carry their measured ``us`` and RHS width
    (``cols=N`` in ``derived``), and the cheapest µs per column across
    them is the seed. With ``platform``, only a record whose
    ``device.platform`` is that one seeds; any other gives an unseeded
    model, as an unreadable record does."""
    try:
        with open(path) as f:
            record = json.load(f)
    except (OSError, ValueError):
        return WaveCostModel()
    if platform is not None and \
            (record.get("device") or {}).get("platform") != platform:
        return WaveCostModel()
    best: Optional[float] = None
    for row in record.get("rows", []):
        name = str(row.get("name", ""))
        derived = str(row.get("derived", ""))
        if not name.startswith("incrs_spmm") or "cols=" not in derived:
            continue
        try:
            cols = int(derived.split("cols=")[1].split(";")[0])
            us = float(row["us"])
        except (KeyError, IndexError, ValueError):
            continue
        if cols > 0 and us > 0:
            per = us / cols
            best = per if best is None else min(best, per)
    if best is None:
        return WaveCostModel()
    return WaveCostModel(best, 0.0, source=f"bench[{path}]")


def seed_cost_model(bench_path: Optional[str] = None,
                    platform: Optional[str] = None) -> WaveCostModel:
    """Best available offline seed, in JAX's order: the bench record
    (``seed_from_bench``), else unseeded (the first retired wave then
    provides the estimate). JAX first asks the autotuner's measurements
    for this operand's exact geometry; the port has no autotuner yet
    (ROADMAP queue 1 item 9), so that step is not taken."""
    if bench_path is not None:
        model = seed_from_bench(bench_path, platform)
        if model.us_per_col is not None:
            return model
    return WaveCostModel()


@dataclasses.dataclass
class WavePacker:
    """Latency-aware wave packing over a deque of requests.

    ``budget_us`` — per-wave latency target; None = pack to the hard cap.
    ``skip_limit`` — how many non-fitting requests one wave may scan past;
    0 is the strict-FIFO wave barrier.
    """
    cost: WaveCostModel = dataclasses.field(default_factory=WaveCostModel)
    budget_us: Optional[float] = None
    skip_limit: int = DEFAULT_SKIP_LIMIT
    last_target: Optional[int] = None

    def target_cols(self, hard_cap: int) -> int:
        target = self.cost.target_cols(self.budget_us, hard_cap)
        self.last_target = target
        return target

    def next_wave(self, queue: Deque, hard_cap: int) -> List:
        """Pop the next wave off ``queue``: requests are admitted front to
        back while they fit the target width; at most ``skip_limit``
        non-fitting ones are bypassed and restored to the front in their
        original order. A head request at least as wide as the target is
        admitted alone."""
        if not queue:
            return []
        target = self.target_cols(hard_cap)
        wave: List = []
        bypassed: List = []
        cols = 0
        skips = 0
        while queue:
            req = queue.popleft()
            width = req.b.shape[1]
            if not wave and width >= target:
                wave.append(req)            # wide head: ship it alone
                cols += width
                break
            if cols + width <= target:
                wave.append(req)
                cols += width
            else:
                bypassed.append(req)
                skips += 1
                if skips >= max(0, self.skip_limit) + (0 if wave else 1):
                    break
        queue.extendleft(reversed(bypassed))
        return wave

    def observe(self, cols: int, wall_us: float) -> None:
        self.cost.observe(cols, wall_us)


__all__ = ["WaveCostModel", "WavePacker", "fit_us_per_col",
           "seed_from_bench", "seed_cost_model", "MIN_TARGET_COLS",
           "DEFAULT_SKIP_LIMIT"]
