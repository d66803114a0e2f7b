"""Multi-tenant SpMM serving: many resident operands behind one process.

The port of ``repro.serve.tenancy``. ``TenantPool`` keeps one
``SpMMEngine`` per named operand behind a single submit/run surface, under
an LRU budget of device bytes: when admitting or reviving a tenant would
exceed the budget, the least recently used IDLE tenant is evicted. Its
engine is dropped (and, for a raw InCRS operand, its ``ops.prepare_incrs``
memo entry, so the stripes are really freed) while the operand it was
given is kept, so a later request re-preps it. Tenants with queued or
in-flight work are never evicted; if every resident tenant is busy the
pool overcommits and records it (``budget_overcommit``).

A tenant keeps the operand it was given, as in JAX. For an InCRS operand
that is a host object; a bound plan (``sparse.BoundPlan``) already lives
on the card, so evicting its tenant frees only what its engine made.

``smem_report`` gives, per resident tenant, the shared memory one launch
needs at the engine's wave cap: residency is a question of device bytes,
launch feasibility one of shared memory, and the pool keeps both visible.

``swap_pattern`` works per tenant while requests are queued: it delegates
to the engine's swap (in-flight waves finish on the old operand; a
rejected swap leaves queue and operand intact) and replaces the kept
operand, so a later evict/revive cycle rebuilds the NEW pattern.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, defaultdict
from typing import Any, Dict, List, Optional

import torch

from ..core.incrs import InCRS
from ..kernels import _gemm, bsr_spmm, dense_mm, incrs_spmm, ops
from .engine import WAVE_QUANTUM, SpMMEngine, SpMMRequest

# Default resident-operand byte budget: a couple of large prepped
# operands, not the card's memory. The pool's job is the eviction
# discipline; deployments size this to their card.
DEFAULT_HBM_BUDGET = 256 * 1024 * 1024


def _plan_tensors(bound) -> List[torch.Tensor]:
    """Every tensor a bound plan keeps on its device: the values, the
    device-ready form its bind built (stripes with their indices, padded
    slots, a contiguous A) and, for ``bsr``, the block lists."""
    ready = bound._ready
    out = [bound.values] if isinstance(bound.values, torch.Tensor) \
        else list(bound.values)
    if isinstance(ready, ops.PreparedOperand):
        out += [ready.idx, ready.val]
    elif isinstance(ready, ops.ShardedPreparedOperand):
        out += [*ready.idx, *ready.val]
    elif isinstance(ready, torch.Tensor):
        out.append(ready)
    else:
        out += list(ready)
    if bound.plan.spec.format == "bsr":
        out += list(bound.plan.meta.kernel_index(bound.device))
    return out


def operand_bytes(prep) -> int:
    """Device-resident bytes of one serving operand: the stripes (idx +
    val) of a prepped InCRS, every shard's for a sharded one (summed over
    its devices); for a bound plan, every storage ``_plan_tensors`` names,
    each counted once. Host-side originals do not count: they are what
    eviction falls back to."""
    if isinstance(prep, ops.PreparedOperand):
        return int(prep.idx.nbytes) + int(prep.val.nbytes)
    if isinstance(prep, ops.ShardedPreparedOperand):
        return sum(int(t.nbytes) for t in (*prep.idx, *prep.val))
    seen: Dict[int, int] = {}
    for t in _plan_tensors(prep):
        st = t.untyped_storage()
        seen[st.data_ptr()] = int(st.nbytes())
    return sum(seen.values())


@dataclasses.dataclass
class _Tenant:
    name: str
    a: Any                                 # the operand it was given
    engine_kwargs: Dict[str, Any]
    engine: Optional[SpMMEngine] = None    # None = evicted
    resident_bytes: int = 0
    finished: List[SpMMRequest] = dataclasses.field(default_factory=list)
    evictions: int = 0

    @property
    def resident(self) -> bool:
        return self.engine is not None

    @property
    def busy(self) -> bool:
        """Queued, staged, or in-flight work — never evictable."""
        e = self.engine
        return e is not None and bool(e.queue or e._staged is not None
                                      or e._inflight is not None)


class TenantPool:
    """LRU-budgeted pool of named ``SpMMEngine`` tenants.

    ``engine_kwargs`` passed to :meth:`add` (``max_wave_cols``,
    ``latency_budget_us``, ``variant``, ``device``, ...) are kept and
    applied again when an evicted tenant is revived, so a tenant's serving
    configuration survives eviction as its operand does.
    """

    def __init__(self, *, hbm_budget_bytes: int = DEFAULT_HBM_BUDGET,
                 **engine_defaults):
        if hbm_budget_bytes <= 0:
            raise ValueError(f"hbm_budget_bytes must be positive, got "
                             f"{hbm_budget_bytes}")
        self.hbm_budget_bytes = hbm_budget_bytes
        self.engine_defaults = engine_defaults
        # The OrderedDict is the LRU: most recently used tenants last.
        self._tenants: "OrderedDict[str, _Tenant]" = OrderedDict()
        self.stats: Dict[str, int] = defaultdict(int)

    # -- residency -------------------------------------------------------
    def resident_bytes(self) -> int:
        return sum(t.resident_bytes for t in self._tenants.values()
                   if t.resident)

    def _touch(self, name: str) -> None:
        self._tenants.move_to_end(name)

    def _build_engine(self, tenant: _Tenant) -> None:
        kwargs = dict(self.engine_defaults)
        kwargs.update(tenant.engine_kwargs)
        tenant.engine = SpMMEngine(tenant.a, **kwargs)
        tenant.resident_bytes = operand_bytes(tenant.engine.prep)
        self.stats["builds"] += 1

    def _evict_for(self, incoming: Optional[str]) -> None:
        """Evict idle LRU tenants until the pool fits its budget; a fully
        busy pool overcommits (recorded) instead of dropping work."""
        while self.resident_bytes() > self.hbm_budget_bytes:
            victim = None
            for t in self._tenants.values():         # LRU -> MRU order
                if t.name != incoming and t.resident and not t.busy:
                    victim = t
                    break
            if victim is None:
                self.stats["budget_overcommit"] += 1
                return
            self.evict(victim.name)

    def evict(self, name: str) -> None:
        """Drop a tenant's engine and what it holds on the card (its
        operand and served results are kept; a later request revives
        it)."""
        t = self._require(name)
        if not t.resident:
            return
        if t.busy:
            raise ValueError(f"tenant {name!r} has queued or in-flight "
                             f"requests — drain it before evicting")
        t.finished.extend(t.engine.finished)
        # A raw InCRS is prepped through the memo of ops, which would keep
        # its stripes alive after the engine is gone.
        if isinstance(t.a, InCRS):
            ops.invalidate_prepared(t.a)
        t.engine = None
        t.resident_bytes = 0
        t.evictions += 1
        self.stats["evictions"] += 1

    def _ensure_resident(self, name: str) -> _Tenant:
        t = self._require(name)
        if not t.resident:
            self._build_engine(t)
            self.stats["revivals"] += 1
        self._touch(name)
        self._evict_for(name)
        return t

    def _require(self, name: str) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            raise KeyError(f"unknown tenant {name!r}; resident/known: "
                           f"{list(self._tenants)}")
        return t

    # -- tenant surface --------------------------------------------------
    def add(self, name: str, a, **engine_kwargs) -> SpMMEngine:
        """Register (and build) a tenant. ``a`` and ``engine_kwargs``
        take everything ``SpMMEngine`` does; both are kept so the tenant
        can be revived after eviction."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already exists — use "
                             f"swap_pattern to change its operand")
        t = _Tenant(name=name, a=a, engine_kwargs=engine_kwargs)
        self._tenants[name] = t
        self._build_engine(t)
        self._touch(name)
        self._evict_for(name)
        return t.engine

    def submit(self, name: str, req: SpMMRequest) -> None:
        t = self._ensure_resident(name)
        t.engine.submit(req)

    def swap_pattern(self, name: str, a) -> None:
        """Swap one tenant's operand (engine semantics: queued work is
        safe, a rejected swap rolls back). On success the kept operand is
        replaced too, so an evict/revive cycle rebuilds the new
        pattern."""
        t = self._ensure_resident(name)
        t.engine.swap_pattern(a)
        t.a = a
        t.resident_bytes = operand_bytes(t.engine.prep)
        self._evict_for(name)

    def run(self, name: Optional[str] = None) -> List[SpMMRequest]:
        """Drain one tenant (``name``) or every tenant's queue. Across
        tenants, the next wave goes to the engine whose head request has
        waited longest, so no tenant starves because another is
        chatty."""
        if name is not None:
            t = self._ensure_resident(name)
            return t.engine.run()
        served: List[SpMMRequest] = []
        while True:
            busy = [t for t in self._tenants.values() if t.busy]
            if not busy:
                break
            t = min(busy, key=_head_wait_key)
            before = len(t.engine.finished)
            t.engine.step()
            served.extend(t.engine.finished[before:])
            self._touch(t.name)
        return served

    def results(self, name: str) -> List[SpMMRequest]:
        """Everything this tenant ever served (across evictions)."""
        t = self._require(name)
        out = list(t.finished)
        if t.resident:
            out.extend(t.engine.finished)
        return out

    def engine(self, name: str) -> SpMMEngine:
        """The tenant's live engine (reviving it if evicted)."""
        return self._ensure_resident(name).engine

    # -- reporting -------------------------------------------------------
    def tenants(self) -> List[str]:
        return list(self._tenants)

    def summary(self) -> Dict[str, Any]:
        per_tenant = {}
        for t in self._tenants.values():
            row: Dict[str, Any] = {
                "resident": t.resident,
                "resident_bytes": t.resident_bytes,
                "evictions": t.evictions,
            }
            if t.resident:
                row["engine"] = t.engine.stats_summary()
            per_tenant[t.name] = row
        return {
            "hbm_budget_bytes": self.hbm_budget_bytes,
            "resident_bytes": self.resident_bytes(),
            "n_tenants": len(self._tenants),
            "n_resident": sum(t.resident for t in self._tenants.values()),
            "stats": dict(self.stats),
            "tenants": per_tenant,
        }

    def smem_report(self) -> Dict[str, Any]:
        """Shared memory one launch of each RESIDENT tenant needs at its
        engine's wave cap (bucketed to ``WAVE_QUANTUM``), from the
        wrappers' own geometry functions, beside the card's limit per
        block. The counterpart of JAX ``TenantPool.vmem_report``."""
        rows = {}
        for t in self._tenants.values():
            if not t.resident:
                continue
            kernel, smem = _launch_smem(t.engine)
            rows[t.name] = {"kernel": kernel,
                            "max_wave_cols": t.engine.max_wave_cols,
                            "smem_bytes": smem,
                            "device_bytes": t.resident_bytes}
        return {"limit_bytes": _gemm.SMEM_LIMIT, "tenants": rows}


def _launch_smem(engine: SpMMEngine):
    """(kernel, shared memory bytes) of one launch of ``engine`` at its
    widest wave, as the wrapper would launch it."""
    n = -(-engine.max_wave_cols // WAVE_QUANTUM) * WAVE_QUANTUM
    geom = engine._operand_geometry()
    if geom is not None:
        rows, _, smax, section = geom
        variant = "expand" if engine.variant == "auto" else engine.variant
        name = {"expand": "incrs_spmm", "reuse": "incrs_spmm_reuse",
                "pipelined": "incrs_spmm_pipelined"}[variant]
        bn = ops.default_bn(n)
        g = incrs_spmm.launch_geometry(name, -(-n // bn) * bn, smax,
                                       section, m=rows)
        return name, int(g.smem if hasattr(g, "smem") else g[1])
    bound = engine.prep
    meta = bound.plan.meta
    if bound.plan.spec.format == "bsr":
        g = bsr_spmm.gemm_geometry(meta.n_block_rows, meta.block,
                                   meta.block, n, bound.values.dtype,
                                   nnz=len(meta.col_of))
        return "bsr_spmm", int(g.smem)
    m, k = bound.shape
    return "dense_mm", int(dense_mm.gemm_geometry(m, n, k,
                                                  bound.values.dtype).smem)


def _head_wait_key(t: _Tenant) -> float:
    """Sort key: earliest head-of-queue submit time first; tenants with
    only staged/in-flight work (no queue head) come first of all, so the
    pipeline drains before new admissions."""
    e = t.engine
    if e.queue:
        head = e.queue[0]
        return head.t_submit if head.t_submit is not None else 0.0
    return float("-inf")


__all__ = ["TenantPool", "operand_bytes", "DEFAULT_HBM_BUDGET"]
