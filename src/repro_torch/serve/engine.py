"""Serving engines on the port's kernels.

``ServeEngine`` is the port of the LM engine of ``repro.serve.engine``:
requests are grouped into waves of equal prompt length (up to ``n_slots``
per wave); each wave is prefilled as one batch and decoded in lockstep,
one token per step for every lane. A prompt of ``FLASH_THRESHOLD`` tokens
or more prefills through the flash kernel. An embeds model (``cfg.input_mode
== "embeds"``) prefills each prompt after ``n_prefix_embeds`` zero
front-end embeddings, the modality stub, as the JAX engine does.

``SpMMEngine`` is the paper's own workload as a service, one fixed sparse
operand A and a queue of dense right-hand sides to multiply against it. A
is an InCRS operand (the fused InCRS kernels) or a bound plan of the
plan–execute API (``incrs``, ``bsr`` or ``dense``, one kernel launch per
wave each), or row-sharded across a ``launch.mesh.Mesh`` (one launch a
shard a wave, each shard's rows copied straight into its rows of the
host panel). ``swap_pattern`` replaces A between waves, for instance with
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
from ..models import layers
from ..models import model as M
from ..sparse import linear as _lin
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
        cfg = self.cfg
        pfx = None
        npfx = cfg.n_prefix_embeds if cfg.input_mode == "embeds" else 0
        if npfx:
            # the modality stub: zero front-end embeddings
            pfx = torch.zeros((bsz, npfx, cfg.d_model), device=dev,
                              dtype=layers.torch_dtype(cfg.dtype))
        t0 = time.perf_counter()
        # the prefix takes cache positions too: decode reaches position
        # s + npfx + max_new - 1, so the allocation counts it
        logits, cache = M.prefill_step(
            self.model, prompts, prefix_embeds=pfx,
            alloc_seq=s + npfx + max_new + self.alloc_extra,
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
                cache, pos=s + npfx + step - 1)
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
    retires; ``b`` is B on each device the operand's launches run on,
    ``ready`` the event of B's arrival there (CUDA only). ``panel`` is the
    host panel C is copied into at dispatch, and ``done`` the events that
    end those copies, one a device (CUDA only)."""
    items: List[Any]
    host: torch.Tensor
    b: Dict[torch.device, torch.Tensor]    # wave RHS on each device
    prep_s: float                          # host prep wall time
    hidden: bool                           # prepped while a wave was in flight
    ready: Dict[torch.device, Any] = dataclasses.field(default_factory=dict)
    panel: Optional[torch.Tensor] = None
    done: List[Any] = dataclasses.field(default_factory=list)
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


def _operand_device(a, mesh=None) -> Optional[torch.device]:
    """The device an already device-ready operand lives on (a sharded
    one's first shard's), or the first device of ``mesh``, else None."""
    from ..sparse import api
    if isinstance(a, api.Linear):
        a = a.inner
        if not isinstance(a, _lin.ShardedInCRSLinearParams):
            return a.values.device
    if isinstance(a, _lin.ShardedInCRSLinearParams):
        return a.meta.devices[0]
    if isinstance(a, (ops.PreparedOperand, ops.ShardedPreparedOperand,
                      api.BoundPlan)):
        return a.device
    if mesh is not None:
        return ops.resolve_device(mesh.device_list[0])
    return None


def _sharded_of(prep) -> Optional[ops.ShardedPreparedOperand]:
    """The row-sharded stripes an operand launches (a sharded prep, or a
    sharded ``incrs`` plan's), else None."""
    if isinstance(prep, ops.ShardedPreparedOperand):
        return prep
    ready = getattr(prep, "_ready", None)
    return ready if isinstance(ready, ops.ShardedPreparedOperand) else None


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

    On CUDA the engine owns one copy stream a device. B's copy to the
    card runs on it, and the compute stream (the current stream at
    dispatch) waits for it just before the launch; right after the launch
    the copy stream waits for the compute stream and copies C into a
    pinned host panel (``_PanelRing``). Retiring waits for those copies'
    events alone. A row-sharded operand (``mesh=``, a
    ``ShardedPreparedOperand``, a sharded ``incrs`` plan or layer) gets B
    once on each distinct device of its shards, one launch a shard, and
    each shard's rows copied into their rows of the host panel; the
    engine's ``device`` is its first shard's. On the CPU the same ring
    holds unpinned panels and the copies are synchronous. A continuous
    engine seeds its cost model from the autotuner's measurements of its
    operand's exact stripes on its device
    (``scheduler.seed_from_autotune``), then, on CUDA, from a bench record
    taken on a GPU (``DEFAULT_BENCH`` in the working directory); else it
    starts unseeded.
    """

    def __init__(self, a, *, max_wave_cols: int = 512,
                 variant: str = "auto", device=None, mesh=None,
                 shard_axis=None, continuous: bool = True,
                 latency_budget_us: Optional[float] = None,
                 scheduler: Optional[_sched.WavePacker] = None,
                 skip_limit: Optional[int] = None):
        """``a``: an ``InCRS`` (prepped here, once, on ``device``, or
        row-sharded across ``mesh`` along ``shard_axis``), an
        ``ops.PreparedOperand`` or ``ops.ShardedPreparedOperand``, a
        ``sparse.BoundPlan``, a ``sparse.Linear`` or a sharded InCRS
        layer's params (served on their own devices; a Linear through
        ``.bound()``, sharded params through ``.prep``). ``variant``
        selects the InCRS kernel grid order as in ``ops.spmm``; a bound
        plan has one kernel."""
        ops.check_variant(variant)
        on_device = _operand_device(a, mesh)
        self.device = on_device if device is None and on_device is not None \
            else ops.resolve_device(device)
        self.max_wave_cols = max_wave_cols
        self.variant = variant
        self.a, self.prep, self.pattern_version = self._build_operand(
            a, mesh, shard_axis)
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
        self._copy: Dict[torch.device, Any] = {}    # device -> copy stream
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
        this operand's stripes (its geometry, a shard's for a sharded
        operand, its launches a wave counted on the busiest device) on
        this device's backend; then, on CUDA, ``DEFAULT_BENCH`` if it was
        taken on a GPU; else unseeded (the first retired wave gives the
        estimate)."""
        from ..kernels import autotune
        geo = self._operand_geometry() or (None,) * 4
        cuda = self.device.type == "cuda"
        return _sched.seed_cost_model(
            *geo, backend=autotune.backend_name(self.device),
            bench_path=DEFAULT_BENCH if cuda else None,
            platform="gpu" if cuda else None,
            launches=self._serial_launches())

    def _serial_launches(self) -> int:
        """The kernel launches a wave queues on its busiest device: one,
        or for a sharded operand the most shards one device holds (shards
        on distinct cards run side by side)."""
        sh = _sharded_of(self.prep)
        if sh is None:
            return 1
        per: Dict[torch.device, int] = defaultdict(int)
        for d in sh.devices:
            per[d] += 1
        return max(per.values())

    def _operand_geometry(self):
        """(padded_rows, n_sections, smax, section) of the InCRS stripes
        one launch serves (a raw or prepped InCRS, an ``incrs`` plan, a
        sharded operand's panel), or None for an operand without them (a
        ``bsr`` or ``dense`` plan)."""
        from ..sparse import api
        prep = self.prep
        if isinstance(prep, api.BoundPlan):
            prep = prep._ready
        if isinstance(prep, ops.ShardedPreparedOperand):
            prep = prep.shard(0)
        if not isinstance(prep, ops.PreparedOperand):
            return None
        return (*(int(x) for x in prep.idx.shape), int(prep.section))

    def _build_operand(self, a, mesh=None, shard_axis=None):
        """Resolve ``a`` to ``(operand, prep, pattern_version)`` without
        touching engine state, so a rejected swap leaves the engine as it
        was."""
        from ..sparse import api
        version = None
        if isinstance(a, _lin.ShardedInCRSLinearParams):
            version = getattr(a.pattern, "version", None)
            a = a.prep                # the layer's stripes, as they are now
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
        if isinstance(a, api.BoundPlan) and mesh is not None:
            raise ValueError(
                "a bound plan is already committed to its layout; rebuild "
                "it with a mesh on the spec instead of mesh=")
        if isinstance(a, ops.ShardedPreparedOperand) and mesh is not None \
                and mesh is not a.mesh:
            raise ValueError(
                "the ShardedPreparedOperand is already bound to a mesh; "
                "drop mesh=, or re-prep the raw InCRS on the new mesh")
        if isinstance(a, ops.PreparedOperand) and mesh is not None:
            raise ValueError(
                "cannot re-shard an already-built single-device "
                "PreparedOperand; pass the raw InCRS with mesh=, or an "
                "ops.ShardedPreparedOperand")
        if isinstance(a, InCRS) and mesh is not None:
            a = ops.prepare_incrs_sharded(a, mesh, axis=shard_axis)
        if isinstance(a, (ops.PreparedOperand, ops.ShardedPreparedOperand,
                          api.BoundPlan)):
            if a.device != self.device:
                raise ValueError(f"operand lives on {a.device}, the engine "
                                 f"serves on {self.device}")
            if isinstance(a, api.BoundPlan):
                version = getattr(a.pattern, "version", None)
            return a, a, version
        if isinstance(a, InCRS):
            return a, ops.prepare_incrs(a, device=self.device), None
        raise TypeError(
            f"SpMMEngine serves an InCRS, an ops.PreparedOperand or "
            f"ShardedPreparedOperand, a sparse.BoundPlan or a sparse.Linear, "
            f"got {type(a).__name__}")

    @property
    def sharded(self) -> bool:
        """Whether the operand served now is row-sharded."""
        return _sharded_of(self.prep) is not None

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
        if isinstance(prep, ops.ShardedPreparedOperand):
            prep = prep.shard(0)                # each shard launches this
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
    def swap_pattern(self, a, *, mesh=None, shard_axis=None) -> None:
        """Hot-swap the serving operand between waves, across formats
        (InCRS, ``incrs``, ``bsr`` and ``dense`` plans replace each other
        freely, and single-device and sharded operands too): deploy a
        re-pruned layer (``sparse.magnitude_repack``) into the running
        engine. ``a``, ``mesh`` and ``shard_axis`` take what the
        constructor takes; a layer's or plan's pattern version is recorded
        in ``pattern_version``. The new operand's shape must match the
        current one, and its launch must pass the launch check
        (``_check_feasible``); a rejected swap (ValueError, a
        ``KernelConfigError`` among them) leaves the engine serving the OLD
        operand. An in-flight wave keeps the operand it was launched
        with."""
        new_a, new_prep, new_version = self._build_operand(a, mesh,
                                                           shard_axis)
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
        w = _Wave(wave, host, {}, 0.0, hidden)
        for dev in self._launch_devices():
            self._put_rhs(w, dev)
        w.prep_s = time.perf_counter() - t0
        self._prep_s_total += w.prep_s
        if hidden:
            self._prep_s_hidden += w.prep_s
        self._staged = w
        return True

    def _launch_devices(self) -> List[torch.device]:
        """The distinct devices the operand's launches run on."""
        sh = _sharded_of(self.prep)
        return [self.device] if sh is None else \
            list(dict.fromkeys(sh.devices))

    def _copy_stream(self, dev: torch.device):
        """The engine's copy stream on ``dev`` (CUDA), made on first use."""
        st = self._copy.get(dev)
        if st is None:
            st = self._copy[dev] = torch.cuda.Stream(dev)
        return st

    def _put_rhs(self, w: _Wave, dev: torch.device) -> torch.Tensor:
        """The wave's B on ``dev``: the host panel itself on the CPU, else
        an async copy on ``dev``'s copy stream whose event marks it
        landed."""
        b = w.b.get(dev)
        if b is None:
            if dev.type != "cuda":
                b = w.host
            else:
                copy = self._copy_stream(dev)
                with torch.cuda.stream(copy):
                    b = w.host.to(dev, non_blocking=True)
                w.ready[dev] = copy.record_event()
            w.b[dev] = b
        return b

    def _dispatch(self) -> None:
        """Launch the staged wave and queue the copy of its result to a
        host panel; the operand is captured here, so a ``swap_pattern``
        after dispatch never touches an in-flight wave."""
        w = self._staged
        if w is None:
            return
        t0 = time.perf_counter()
        # B where each launch runs (a swap since staging may have moved
        # the operand), the compute streams waiting for its copies
        bs = {}
        for dev in self._launch_devices():
            bs[dev] = self._put_rhs(w, dev)
            if dev in w.ready:
                compute = torch.cuda.current_stream(dev)
                compute.wait_event(w.ready[dev])
                bs[dev].record_stream(compute)
        sh = _sharded_of(self.prep)
        if sh is not None:
            tuned = self.prep.plan.tuned if sh is not self.prep else None
            parts = ops.sharded_panels(sh, bs, variant=self.variant,
                                       tuned=tuned)
            rows = [sh.row_range(s) for s in range(sh.n_shards)]
        elif isinstance(self.prep, ops.PreparedOperand):
            parts = [ops.spmm(self.prep, bs[self.device],
                              variant=self.variant)]
            rows = [(0, self.prep.shape[0])]
        else:                       # a bound plan: the kernels promote B
            b = bs[self.device]     # with the plan's values and sum in
            if b.dtype.is_floating_point and \
                    torch.finfo(b.dtype).bits > 32:    # f32, as JAX
                b = b.to(torch.float32)             # without x64 does
            parts = [self.prep(b)]
            rows = [(0, self.prep.shape[0])]
        self._staged = None         # a launch that raised keeps the wave
        w.panel = self._panels.take((self.prep.shape[0], parts[0].shape[1]),
                                    parts[0].dtype)
        by_dev: Dict[torch.device, list] = defaultdict(list)
        for c, (lo, hi) in zip(parts, rows):
            by_dev[c.device].append((c, lo, hi))
        for dev, pieces in by_dev.items():
            if dev.type != "cuda":
                for c, lo, hi in pieces:
                    w.panel[lo:hi].copy_(c)
                continue
            copy = self._copy_stream(dev)
            copy.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(copy):
                for c, lo, hi in pieces:    # each shard straight into its
                    w.panel[lo:hi].copy_(c, non_blocking=True)   # rows
                    c.record_stream(copy)
            w.done.append(copy.record_event())
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
        for ev in w.done:
            ev.synchronize()
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
