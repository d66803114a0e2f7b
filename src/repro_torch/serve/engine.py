"""Serving engines on the port's kernels.

``ServeEngine`` is the port of the LM engine of ``repro.serve.engine``:
requests are grouped into waves of equal prompt length (up to ``n_slots``
per wave); each wave is prefilled as one batch and decoded in lockstep,
one token per step for every lane. A prompt of ``FLASH_THRESHOLD`` tokens
or more prefills through the flash kernel.

``SpMMEngine`` is the paper's own workload as a service, one fixed sparse
operand A and a queue of dense right-hand sides to multiply against it. A
is an InCRS operand (the fused InCRS kernels) or a bound plan of the
plan–execute API (``incrs``, ``bsr`` or ``dense``, one kernel launch per
wave each). ``swap_pattern`` replaces A between waves, for instance with
a re-pruned layer (``sparse.magnitude_repack``), and records its
pattern's version.
Requests are packed into waves (``serve.scheduler``), each wave is staged
on the host, launched, and retired, with the host prep of wave N+1 done
while wave N computes. On CUDA both copies of a wave run on a copy stream
of the engine's own: B to the card, and C back into a pinned host panel.
The host blocks only where a wave retires, and then only until that
wave's own result has landed.
"""
from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from collections import defaultdict, deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from ..core.incrs import InCRS
from ..kernels import ops
from ..models import model as M
from . import scheduler as _sched


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                     # (S,) int
    max_new: int = 16
    temperature: float = 0.0               # 0 = greedy
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Wave-batched LM serving on the model's device.

    All lanes of a wave share one position counter, so the ring-buffer
    arithmetic of every cache is exact. A lane that has its ``max_new``
    tokens is frozen: it is neither sampled (so it draws nothing from the
    shared generator) nor fed a new token, though the lockstep batch still
    carries it. Sampling is the JAX engine's, numpy's ``default_rng(seed)``
    on the f32 logits, so both engines draw the same tokens from the same
    logits. ``prefill_ms`` (one per wave) and ``decode_ms`` (one per step)
    are host times up to the logits' arrival on the host.
    """

    def __init__(self, model: M.Model, *, n_slots: int = 4,
                 alloc_extra: int = 64, cache_dtype=torch.bfloat16,
                 seed: int = 0):
        self.model, self.cfg = model, model.cfg
        self.n_slots = n_slots
        self.alloc_extra = alloc_extra
        self.cache_dtype = cache_dtype
        self.rng = np.random.default_rng(seed)
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.stats: Dict[str, int] = defaultdict(int)
        self.prefill_ms: List[float] = []
        self.decode_ms: List[float] = []

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _next_wave(self) -> List[Request]:
        """Up to n_slots queued requests sharing one prompt length, the
        largest group first."""
        if not self.queue:
            return []
        by_len: Dict[int, List[Request]] = defaultdict(list)
        for r in self.queue:
            by_len[len(r.prompt)].append(r)
        length = max(by_len, key=lambda k: len(by_len[k]))
        wave = by_len[length][: self.n_slots]
        for r in wave:
            self.queue.remove(r)
        return wave

    def _sample(self, logits_row: np.ndarray, temp: float) -> int:
        if temp <= 0.0:
            return int(np.argmax(logits_row))
        z = logits_row / temp
        z = z - z.max()
        prob = np.exp(z)
        prob /= prob.sum()
        return int(self.rng.choice(len(prob), p=prob))

    # ------------------------------------------------------------------
    def _run_wave(self, wave: List[Request]):
        bsz = len(wave)
        s = len(wave[0].prompt)
        max_new = max(r.max_new for r in wave)
        dev = self.model.device
        prompts = torch.as_tensor(np.stack([r.prompt for r in wave]),
                                  device=dev)
        t0 = time.perf_counter()
        logits, cache = M.prefill_step(
            self.model, prompts, alloc_seq=s + max_new + self.alloc_extra,
            cache_dtype=self.cache_dtype)
        lg = logits.to(torch.float32).cpu().numpy()
        self.prefill_ms.append((time.perf_counter() - t0) * 1e3)
        self.stats["prefill_tokens"] += bsz * s
        # Only lanes that want tokens sample: a max_new = 0 request comes
        # back empty and draws nothing that would shift its wave-mates.
        last = np.zeros(bsz, dtype=np.int64)
        for i, r in enumerate(wave):
            if r.max_new > 0:
                last[i] = self._sample(lg[i], r.temperature)
                r.out.append(int(last[i]))
        for step in range(1, max_new):
            t0 = time.perf_counter()
            logits, cache = M.decode_step(
                self.model, torch.as_tensor(last[:, None], device=dev),
                cache, pos=s + step - 1)
            lg = logits.to(torch.float32).cpu().numpy()
            self.decode_ms.append((time.perf_counter() - t0) * 1e3)
            self.stats["decode_tokens"] += bsz
            for i, r in enumerate(wave):
                if len(r.out) < r.max_new:      # finished lanes are frozen
                    tok = self._sample(lg[i], r.temperature)
                    r.out.append(tok)
                    last[i] = tok
        for r in wave:
            r.done = True
            self.finished.append(r)

    # ------------------------------------------------------------------
    def run(self) -> List[Request]:
        """Serve until the queue drains; returns the finished requests."""
        while self.queue:
            self._run_wave(self._next_wave())
            self.stats["waves"] += 1
        return self.finished


@dataclasses.dataclass
class SpMMRequest:
    rid: int
    # (K, cols) dense operand: a numpy array, or a CPU tensor for a type
    # numpy lacks (bfloat16); ``out`` comes back in the same kind and dtype
    b: Any
    out: Any = None                        # (M, cols) result
    done: bool = False
    t_submit: Optional[float] = None       # stamped by engine.submit()
    t_done: Optional[float] = None         # stamped when the result lands


@dataclasses.dataclass
class _SplitPart:
    """One ``<= max_wave_cols``-wide column chunk of an oversized request.
    Parts flow through the packer like requests (they expose ``.b``); each
    retires into its parent's preallocated ``out``, and the parent
    completes when its last part does."""
    rid: int
    parent: SpMMRequest
    offset: int                            # column offset into parent.out
    b: Any                                 # column-slice VIEW of parent.b
    t_submit: Optional[float] = None


@dataclasses.dataclass
class _Wave:
    """A packed wave moving through stage -> dispatch -> retire. ``host``
    is the (pinned, on CUDA) staging panel, kept alive until the wave
    retires; ``ready`` marks B's arrival on the card (CUDA only).
    ``panel`` is the host panel C is copied into at dispatch, and
    ``done`` marks the end of that copy (CUDA only)."""
    items: List[Any]
    host: torch.Tensor
    b: torch.Tensor                        # wave RHS on the device
    prep_s: float                          # host prep wall time
    hidden: bool                           # prepped while a wave was in flight
    ready: Any = None                      # torch.cuda.Event
    panel: Optional[torch.Tensor] = None
    done: Any = None                       # torch.cuda.Event
    t_dispatch: Optional[float] = None


# Wave widths are bucketed (zero-padded) up to this quantum before launch,
# so mixed-width traces launch a handful of shapes.
WAVE_QUANTUM = 128

# Host panels per dtype in an engine's ring. One wave is in flight at a
# time and retiring copies its results out, so the panel a wave takes is
# free again long before the ring comes round to it.
PANEL_RING = 2

# The bench record a CUDA engine seeds its cost model from, read from the
# working directory (``python -m repro_torch.benchmarks.serve_bench
# --json BENCH_torch_serve.json``).
DEFAULT_BENCH = "BENCH_torch_serve.json"


class _PanelRing:
    """The host panels waves retire into: ``PANEL_RING`` flat buffers per
    dtype, each of ``rows`` × the wave cap bucketed to ``WAVE_QUANTUM``
    elements, made on first use and handed out in turn, each as a
    contiguous (rows, cols) view of its front. Pinned on CUDA, so the copy
    of C into them runs asynchronously."""

    def __init__(self, rows: int, cap_cols: int, *, pin: bool):
        self.size = rows * (-(-cap_cols // WAVE_QUANTUM) * WAVE_QUANTUM)
        self.pin = pin
        self._bufs: Dict[torch.dtype, List[torch.Tensor]] = {}
        self._next: Dict[torch.dtype, int] = {}

    def take(self, shape, dtype: torch.dtype) -> torch.Tensor:
        n = shape[0] * shape[1]
        if n > self.size:
            raise ValueError(f"a wave's result {tuple(shape)} exceeds the "
                             f"host panels of {self.size} elements")
        bufs = self._bufs.setdefault(dtype, [])
        i = self._next.get(dtype, 0)
        if i == len(bufs):
            bufs.append(torch.empty(self.size, dtype=dtype,
                                    pin_memory=self.pin))
        self._next[dtype] = (i + 1) % PANEL_RING
        return bufs[i][:n].view(tuple(shape))


def _percentiles_ms(samples: List[float]) -> Dict[str, float]:
    """{p50, p99, mean} in milliseconds from wall-second samples."""
    if not samples:
        return {"p50": 0.0, "p99": 0.0, "mean": 0.0}
    srt = sorted(samples)

    def pct(q: float) -> float:
        return srt[min(len(srt) - 1, int(round(q * (len(srt) - 1))))] * 1e3

    return {"p50": pct(0.50), "p99": pct(0.99),
            "mean": sum(srt) / len(srt) * 1e3}


def _operand_device(a) -> Optional[torch.device]:
    """The device an already device-ready operand lives on, else None."""
    from ..sparse import api
    if isinstance(a, api.Linear):
        return a.values.device
    if isinstance(a, (ops.PreparedOperand, api.BoundPlan)):
        return a.device
    return None


def _torch_dtype(b) -> torch.dtype:
    """The torch dtype of a request panel (a numpy array or a CPU
    tensor)."""
    if isinstance(b, torch.Tensor):
        return b.dtype
    return torch.from_numpy(np.empty(0, dtype=b.dtype)).dtype


def _host_tensor(b) -> torch.Tensor:
    return b if isinstance(b, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(b))


def _in_kind_of(panel: torch.Tensor, b):
    """A copy of a result panel (a CPU tensor) in the request's own dtype
    and kind: a tensor for a tensor request, a numpy array for an array
    (numpy has no bfloat16, so a bf16 panel is widened first). It owns its
    memory, since later waves reuse the panel."""
    if isinstance(b, torch.Tensor):
        return torch.empty(tuple(panel.shape), dtype=b.dtype).copy_(panel)
    if panel.dtype == torch.bfloat16:
        panel = panel.float()
    return panel.numpy().astype(b.dtype)


class SpMMEngine:
    """Continuous-batching SpMM serving on one device.

    The operand is prepped once at construction (``ops.prepare_incrs``, or
    a plan's bind); every wave reuses it. Waves are packed by the
    cost-model ``WavePacker`` up to the hard cap ``max_wave_cols``;
    requests wider than the cap are split into parts at ``submit()`` and
    reassembled. In continuous mode the host stages wave N+1 (dtype
    promotion, concat into a pinned panel, async copy) while the device
    runs wave N; kernel launches return at once and only retiring waits.
    ``continuous=False`` is the strict wave-barrier loop (FIFO, no
    overlap).

    On CUDA the engine owns one copy stream. B's copy to the card runs on
    it, and the compute stream (the current stream at dispatch) waits for
    it just before the launch; right after the launch the copy stream
    waits for the compute stream and copies C into a pinned host panel
    (``_PanelRing``). Retiring waits for that copy's event alone. On the
    CPU the same ring holds unpinned panels and the copies are
    synchronous. A continuous engine seeds its cost model from the
    autotuner's measurements of its operand's exact stripes on its device
    (``scheduler.seed_from_autotune``), then, on CUDA, from a bench record
    taken on a GPU (``DEFAULT_BENCH`` in the working directory); else it
    starts unseeded.
    """

    def __init__(self, a, *, max_wave_cols: int = 512,
                 variant: str = "auto", device=None, mesh=None,
                 continuous: bool = True,
                 latency_budget_us: Optional[float] = None,
                 scheduler: Optional[_sched.WavePacker] = None,
                 skip_limit: Optional[int] = None):
        """``a``: an ``InCRS`` (prepped here, once, on ``device``), an
        ``ops.PreparedOperand``, a ``sparse.BoundPlan`` or a
        ``sparse.Linear`` (served on their own device; a Linear through
        ``.bound()``). ``variant`` selects the InCRS kernel grid order as in
        ``ops.spmm``; a bound plan has one kernel."""
        ops.check_variant(variant)
        if mesh is not None:
            raise NotImplementedError(
                "row-sharded serving is not ported yet (ROADMAP queue 1 "
                "item 8)")
        on_device = _operand_device(a)
        self.device = on_device if device is None and on_device is not None \
            else ops.resolve_device(device)
        self.max_wave_cols = max_wave_cols
        self.variant = variant
        self.a, self.prep, self.pattern_version = self._build_operand(a)
        self.continuous = continuous
        if scheduler is None:
            if skip_limit is None:
                skip_limit = _sched.DEFAULT_SKIP_LIMIT if continuous else 0
            scheduler = _sched.WavePacker(
                cost=self._seed_cost_model() if continuous
                else _sched.WaveCostModel(),
                budget_us=latency_budget_us if continuous else None,
                skip_limit=skip_limit)
        self.scheduler = scheduler
        cuda = self.device.type == "cuda"
        self._copy = torch.cuda.Stream(self.device) if cuda else None
        self._panels = _PanelRing(self.prep.shape[0], max_wave_cols,
                                  pin=cuda)
        self.queue: Deque[Any] = deque()
        self.finished: List[SpMMRequest] = []
        self.stats: Dict[str, int] = defaultdict(int)
        self._staged: Optional[_Wave] = None
        self._inflight: Optional[_Wave] = None
        self._wave_wall_s: List[float] = []
        self._queue_wait_s: List[float] = []
        self._req_latency_s: List[float] = []
        self._prep_s_total = 0.0
        self._prep_s_hidden = 0.0
        self._t_first_submit: Optional[float] = None
        self._t_last_done: Optional[float] = None

    def _seed_cost_model(self) -> _sched.WaveCostModel:
        """The packer's offline µs/col seed: the autotuner's entries for
        this operand's stripes (its geometry) on this device's backend;
        then, on CUDA, ``DEFAULT_BENCH`` if it was taken on a GPU; else
        unseeded (the first retired wave gives the estimate)."""
        from ..kernels import autotune
        geo = self._operand_geometry() or (None,) * 4
        cuda = self.device.type == "cuda"
        return _sched.seed_cost_model(
            *geo, backend=autotune.backend_name(self.device),
            bench_path=DEFAULT_BENCH if cuda else None,
            platform="gpu" if cuda else None)

    def _operand_geometry(self):
        """(padded_rows, n_sections, smax, section) of the InCRS stripes
        served (a raw or prepped InCRS, or an ``incrs`` plan), or None for
        an operand without them (a ``bsr`` or ``dense`` plan)."""
        from ..sparse import api
        prep = self.prep
        if isinstance(prep, api.BoundPlan):
            prep = prep._ready
        if not isinstance(prep, ops.PreparedOperand):
            return None
        return (*(int(x) for x in prep.idx.shape), int(prep.section))

    def _build_operand(self, a):
        """Resolve ``a`` to ``(operand, prep, pattern_version)`` without
        touching engine state, so a rejected swap leaves the engine as it
        was."""
        from ..sparse import api
        if isinstance(a, api.SparseSpec):
            raise ValueError(
                "a SparseSpec alone carries no values to serve — build an "
                "operand with sparse.plan_for_operand(a, spec) or pass a "
                "sparse.Linear")
        if isinstance(a, api.MatmulPlan):
            raise ValueError(
                "bind values to the plan first: plan.bind(values) (or "
                "pass a sparse.Linear / its .bound())")
        if isinstance(a, api.Linear):
            a = a.bound()
        if isinstance(a, api.BoundPlan) and a.plan.spec.format == "crs":
            raise ValueError(
                "a crs plan multiplies by a sparse B^T (CRS); the engine "
                "streams dense right-hand sides — call the plan directly")
        if isinstance(a, (ops.PreparedOperand, api.BoundPlan)):
            if a.device != self.device:
                raise ValueError(f"operand lives on {a.device}, the engine "
                                 f"serves on {self.device}")
            version = getattr(a.pattern, "version", None) \
                if isinstance(a, api.BoundPlan) else None
            return a, a, version
        if isinstance(a, InCRS):
            return a, ops.prepare_incrs(a, device=self.device), None
        raise TypeError(
            f"SpMMEngine serves an InCRS, an ops.PreparedOperand, a "
            f"sparse.BoundPlan or a sparse.Linear, got {type(a).__name__}")

    def _check_feasible(self, prep) -> None:
        """Prove an incoming operand's launch for this engine's widest
        wave before it is committed (``analysis.launch_check``): a bound
        plan's tuned config is re-proven at ``max_wave_cols``; InCRS
        stripes (raw, or an untuned ``incrs`` plan's) are held at what a
        wave of ``max_wave_cols`` launches, the pinned variant's own
        geometry or ``auto``'s pick. Raises ``KernelConfigError`` (a
        ValueError)."""
        from ..analysis import launch_check
        from ..kernels import incrs_spmm
        from ..sparse import api
        on_card = self.device.type == "cuda"
        variant = self.variant
        if isinstance(prep, api.BoundPlan):
            prep.plan.check_feasible(self.max_wave_cols, device=self.device)
            if prep.plan.tuned is not None:
                return
            prep, variant = prep._ready, "auto"   # a plan's calls: auto
        if not isinstance(prep, ops.PreparedOperand):
            return
        n = self.max_wave_cols
        variant, bn, geometry = ops.resolve_incrs(prep, n, variant=variant)
        launch_check.require_feasible(
            variant, m=incrs_spmm._resolve_row_tile(prep.padded_rows,
                                                    128)[1],
            n=-(-n // bn) * bn, n_sections=prep.n_sections,
            smax=prep.idx.shape[2], section=prep.section, geometry=geometry,
            on_card=on_card,
            context=f"engine variant={self.variant!r} at max_wave_cols="
                    f"{self.max_wave_cols}")

    # ------------------------------------------------------------------
    def swap_pattern(self, a) -> None:
        """Hot-swap the serving operand between waves, across formats
        (InCRS, ``incrs``, ``bsr`` and ``dense`` plans replace each other
        freely): deploy a re-pruned layer (``sparse.magnitude_repack``) into
        the running engine. ``a`` takes what the constructor takes; a
        layer's or plan's pattern version is recorded in
        ``pattern_version``. The new operand's shape must match the
        current one, and its launch must pass the launch check
        (``_check_feasible``); a rejected swap (ValueError, a
        ``KernelConfigError`` among them) leaves the engine serving the OLD
        operand. An in-flight wave keeps the operand it was launched
        with."""
        new_a, new_prep, new_version = self._build_operand(a)
        self._check_feasible(new_prep)      # the launch proof, pre-commit
        if tuple(new_prep.shape) != tuple(self.prep.shape):
            raise ValueError(
                f"swap_pattern: new operand shape {tuple(new_prep.shape)} "
                f"!= serving shape {tuple(self.prep.shape)} — an engine "
                f"serves one logical A; start a new engine for a new shape")
        self.a, self.prep, self.pattern_version = new_a, new_prep, \
            new_version
        self.stats["pattern_swaps"] += 1

    def submit(self, req: SpMMRequest):
        k = self.a.shape[1]
        if req.b.ndim != 2 or req.b.shape[0] != k:
            raise ValueError(
                f"request {req.rid}: b has shape {req.b.shape}, expected "
                f"({k}, cols) to multiply against A of shape {self.a.shape}")
        req.t_submit = time.perf_counter()
        if self._t_first_submit is None:
            self._t_first_submit = req.t_submit
        cols = req.b.shape[1]
        if cols > self.max_wave_cols:
            req.out = torch.empty((self.prep.shape[0], cols),
                                  dtype=req.b.dtype) \
                if isinstance(req.b, torch.Tensor) else \
                np.empty((self.prep.shape[0], cols), dtype=req.b.dtype)
            n_parts = -(-cols // self.max_wave_cols)
            req._parts_left = n_parts
            for i in range(n_parts):
                lo = i * self.max_wave_cols
                hi = min(cols, lo + self.max_wave_cols)
                self.queue.append(_SplitPart(
                    rid=req.rid, parent=req, offset=lo,
                    b=req.b[:, lo:hi], t_submit=req.t_submit))
            self.stats["split_requests"] += 1
            self.stats["split_parts"] += n_parts
        else:
            self.queue.append(req)

    # -- pipeline stages ------------------------------------------------
    def _stage(self, hidden: bool) -> bool:
        """Pack the next wave and do all its host prep: promote within the
        wave, concatenate into one (pinned) host panel bucketed to
        ``WAVE_QUANTUM`` columns, and start its copy to the device."""
        wave = self.scheduler.next_wave(self.queue, self.max_wave_cols)
        if not wave:
            return False
        t0 = time.perf_counter()
        wave_dt = functools.reduce(torch.promote_types,
                                   (_torch_dtype(r.b) for r in wave))
        if wave_dt.is_floating_point and torch.finfo(wave_dt).bits > 32:
            warnings.warn(
                f"SpMMEngine: wave dtype {wave_dt} exceeds the fused "
                f"kernel's f32 accumulation — results carry the request "
                f"dtype but f32 precision", stacklevel=3)
        cols = sum(r.b.shape[1] for r in wave)
        bucket = -(-cols // WAVE_QUANTUM) * WAVE_QUANTUM
        host = torch.empty((wave[0].b.shape[0], bucket), dtype=wave_dt,
                           pin_memory=self.device.type == "cuda")
        off = 0
        for r in wave:
            width = r.b.shape[1]
            host[:, off:off + width].copy_(_host_tensor(r.b))
            off += width
        if bucket > cols:
            host[:, cols:].zero_()
            self.stats["pad_cols"] += bucket - cols
        ready = None
        if self._copy is None:
            b = host
        else:
            with torch.cuda.stream(self._copy):
                b = host.to(self.device, non_blocking=True)
            ready = self._copy.record_event()
        prep_s = time.perf_counter() - t0
        self._prep_s_total += prep_s
        if hidden:
            self._prep_s_hidden += prep_s
        self._staged = _Wave(wave, host, b, prep_s, hidden, ready)
        return True

    def _dispatch(self) -> None:
        """Launch the staged wave and queue the copy of its result to a
        host panel; the operand is captured here, so a ``swap_pattern``
        after dispatch never touches an in-flight wave."""
        w = self._staged
        if w is None:
            return
        t0 = time.perf_counter()
        b = w.b
        if self._copy is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(w.ready)
            b.record_stream(compute)
        if isinstance(self.prep, ops.PreparedOperand):
            c = ops.spmm(self.prep, b, variant=self.variant)
        else:                       # a bound plan: the kernels promote B
            if b.dtype.is_floating_point and \
                    torch.finfo(b.dtype).bits > 32:    # with the plan's
                b = b.to(torch.float32)     # values and sum in f32, as
            c = self.prep(b)                # JAX without x64 does
        self._staged = None         # a launch that raised keeps the wave
        w.panel = self._panels.take(c.shape, c.dtype)
        if self._copy is None:
            w.panel.copy_(c)
        else:
            self._copy.wait_stream(compute)
            with torch.cuda.stream(self._copy):
                w.panel.copy_(c, non_blocking=True)
            c.record_stream(self._copy)
            w.done = self._copy.record_event()
        w.t_dispatch = t0
        for r in w.items:
            if r.t_submit is not None:
                self._queue_wait_s.append(t0 - r.t_submit)
        self._inflight = w

    def _finish_item(self, r, panel: np.ndarray, t_done: float) -> None:
        if isinstance(r, _SplitPart):
            parent = r.parent
            parent.out[:, r.offset:r.offset + panel.shape[1]] = \
                _in_kind_of(panel, parent.b)
            parent._parts_left -= 1
            if parent._parts_left:
                return
            r = parent                     # last part: parent completes
        else:
            r.out = _in_kind_of(panel, r.b)
        r.done = True
        r.t_done = t_done
        if r.t_submit is not None:
            self._req_latency_s.append(t_done - r.t_submit)
        self.stats["requests"] += 1
        self.finished.append(r)

    def _retire(self) -> None:
        """Wait for the in-flight wave's result to land in its host panel
        (on CUDA, the copy's event) and hand each request a copy of its
        columns in its own dtype. The wall time from dispatch to result on
        the host feeds the packer's cost model."""
        w = self._inflight
        if w is None:
            return
        self._inflight = None
        if w.done is not None:
            w.done.synchronize()
        c = w.panel
        t_done = time.perf_counter()
        wall_s = t_done - w.t_dispatch
        off = 0
        for r in w.items:
            width = r.b.shape[1]
            self._finish_item(r, c[:, off:off + width], t_done)
            off += width
        self.stats["cols"] += off
        self.stats["waves"] += 1
        self._wave_wall_s.append(wall_s)
        self._t_last_done = t_done
        self.scheduler.observe(off, wall_s * 1e6)

    # -- serving loop ----------------------------------------------------
    def step(self, retire: bool = True) -> bool:
        """Advance the pipeline one wave: dispatch (staging first if
        nothing is staged), then in continuous mode stage the NEXT wave
        while the device computes, then retire. ``retire=False`` leaves
        the wave in flight. Returns False when there was nothing to do."""
        if self._inflight is None:
            if self._staged is None and not self._stage(hidden=False):
                return False
            self._dispatch()
        if self.continuous and self._staged is None and self.queue:
            self._stage(hidden=True)       # overlapped with device compute
        if retire:
            self._retire()
        return True

    def run(self) -> List[SpMMRequest]:
        """Serve until the queue and the pipeline drain."""
        while self.queue or self._staged is not None \
                or self._inflight is not None:
            self.step()
        return self.finished

    # -- reporting -------------------------------------------------------
    def stats_summary(self) -> Dict[str, Any]:
        """Requests/s, per-request latency and queue-wait p50/p99, per-wave
        wall p50/p99, and how much host prep the overlap hid."""
        elapsed = 0.0
        if self._t_first_submit is not None \
                and self._t_last_done is not None:
            elapsed = max(0.0, self._t_last_done - self._t_first_submit)
        n = int(self.stats["requests"])
        cost = self.scheduler.cost
        return {
            "mode": "continuous" if self.continuous else "wave_barrier",
            "requests": n,
            "waves": int(self.stats["waves"]),
            "cols": int(self.stats["cols"]),
            "elapsed_s": elapsed,
            "requests_per_s": (n / elapsed) if elapsed > 0 else 0.0,
            "latency_ms": _percentiles_ms(self._req_latency_s),
            "queue_wait_ms": _percentiles_ms(self._queue_wait_s),
            "wave_ms": _percentiles_ms(self._wave_wall_s),
            "prep_s_total": self._prep_s_total,
            "prep_s_hidden": self._prep_s_hidden,
            "prep_overlap_fraction":
                (self._prep_s_hidden / self._prep_s_total)
                if self._prep_s_total > 0 else 0.0,
            "cost_model": {
                "us_per_col": cost.us_per_col,
                "launch_overhead_us": cost.launch_overhead_us,
                "n_observed": cost.n_observed,
                "source": cost.source,
                "last_target_cols": self.scheduler.last_target,
            },
        }
