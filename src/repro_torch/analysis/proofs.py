"""The kernel proofs on the card: the counterpart of
``repro.analysis.grid_interp``'s proof matrix and of
``kernel_check``'s DMA pairing.

JAX proves each Pallas body statically. The port's kernels are CUDA, so
each property is checked by launching every case of ``analysis.cases``
through the wrapper ``ops`` calls, with its memory laid out so that a
fault leaves a trace:

* **bounds** (``grid-oob-access``): every input and output is a view at
  a 128-byte offset inside an allocation with guard bands on both sides,
  at least a row (of the last dimension) and 128 bytes each, filled with a
  sentinel (a NaN with a payload for floats, an out-of-range value for
  indices). After the launch every guard must hold its sentinel (no write
  past a buffer), and an output that is not finite where the plain version
  is finite is a read of a guard (or of memory past it: a fault).
* **accumulator** (``acc-init-gap``, ``acc-flush-gap``): each case runs
  with the outputs (and the GEMM core's split-K workspace) prefilled with
  a NaN pattern, then with a large finite one (large beside the outputs,
  not so large that a sum added to it leaves its bits). An element whose
  bits differ between the two read its output before writing it
  (``acc-init-gap``); an element off the plain version by more than the
  case's tolerance is a sum that did not reach the output
  (``acc-flush-gap``).
* **coverage** (``output-coverage-gap``): no element may keep the prefill
  of both runs where the plain version is finite.
  (``store-before-final-visit`` has no card check: a store that a later
  one overwrites leaves no trace.)
* **race** (``parallel-axis-race``): a third launch, with the NaN prefill
  again, must give the first one's bits where the kernel's source claims
  them (the GEMM core, the InCRS orders, which must also agree with each
  other at one geometry, and every other kernel); where duplicates are
  summed by atomics in no fixed order (``cases.ATOMIC_REPEAT``), within
  the tolerance.
* **dma** (the rings): the cases at 1, 2, ``stages`` and ``stages`` + 1
  trips run in a child process under a watchdog, so that an mbarrier that
  is never completed fails its case (``dma-wait-without-start``) rather
  than hangs the run; ``analysis.sanitizer`` runs synccheck on them.

``run`` launches each family's cases in a child process
(``python -m repro_torch.analysis.proofs --family F``), all families at
once, each under a watchdog; a case that hangs or faults is a finding and
the family resumes after it. ``proof_matrix`` folds the results over
JAX's ten kernel names and five properties: ``proved`` (every case ran on
the card and passed), ``n/a`` with its reason, or the rule of the first
finding; without a card every cell reads ``untested``.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import _alloc, _build
from . import cases as C

# JAX's kernel names and properties (``grid_interp.KERNELS``,
# ``PROPERTIES``), in its order.
KERNELS = ("incrs_spmm", "incrs_spmm_reuse", "incrs_spmm_pipelined",
           "bsr_spmm", "dense_mm", "index_match_spmm", "flash_attention",
           "incrs_gather", "spgemm_condense", "spgemm_merge")
PROPERTIES = ("bounds", "accumulator", "coverage", "race", "dma")

RULE_OOB = "grid-oob-access"
RULE_ACC_INIT = "acc-init-gap"
RULE_ACC_FLUSH = "acc-flush-gap"
RULE_STORE_FINAL = "store-before-final-visit"
RULE_COVERAGE = "output-coverage-gap"
RULE_RACE = "parallel-axis-race"
RULE_UNVERIFIABLE = "grid-unverifiable"
RULE_DMA_READ = "dma-read-before-wait"
RULE_DMA_WAIT = "dma-wait-without-start"
RULE_DMA_LEAK = "dma-unwaited-start"
RULE_DMA_DOUBLE = "dma-double-start"
RULE_DMA_OPAQUE = "dma-unverifiable"

# JAX's rule names (``grid_interp.RULES``), each read as a check on the
# card.
GRID_RULES: Dict[str, str] = {
    RULE_OOB: "a launch writes outside its buffers (a guard band changed) "
              "or reads a guard (a non-finite output where the plain "
              "version is finite), or faults",
    RULE_ACC_INIT: "an output element depends on what its memory held "
                   "before the launch: read before it was written",
    RULE_ACC_FLUSH: "an output element is off the plain version by more "
                    "than the case's tolerance: a sum that did not reach "
                    "the output",
    RULE_STORE_FINAL: "a store a later store overwrites (no card check: "
                      "it leaves no trace)",
    RULE_COVERAGE: "an output element keeps its prefill where the plain "
                   "version is finite: never written",
    RULE_RACE: "a repeat launch gives other bits (or, where atomics sum "
               "duplicates, leaves the tolerance); the InCRS orders "
               "disagree at one geometry",
    RULE_UNVERIFIABLE: "a case that could not be checked: the wrapper "
                       "refused it, or its process ended without a result",
}
# kernel_check's DMA rule names, read on the rings.
DMA_RULES: Dict[str, str] = {
    RULE_DMA_READ: "a ring case at 1, 2, stages or stages + 1 trips reads "
                   "a stage before its copy landed (a result off the "
                   "plain version)",
    RULE_DMA_WAIT: "a ring case never finishes (an mbarrier no copy or "
                   "arrival completes; the watchdog), or synccheck "
                   "reports a barrier error",
    RULE_DMA_LEAK: "a copy still in flight when the kernel ends (the "
                   "sanitizer)",
    RULE_DMA_DOUBLE: "a stage refilled before it was released (the "
                     "sanitizer's racecheck on the ring)",
    RULE_DMA_OPAQUE: "a ring the checks cannot drive",
}
RULES: Dict[str, str] = {**GRID_RULES, **DMA_RULES}

_PROP_RULES = {
    "bounds": (RULE_OOB,),
    "accumulator": (RULE_ACC_INIT, RULE_ACC_FLUSH),
    "coverage": (RULE_COVERAGE, RULE_STORE_FINAL),
    "race": (RULE_RACE,),
    "dma": tuple(DMA_RULES),
}

WATCHDOG_S = 60.0          # a family's child; a hang is a finding
GUARD_ALIGN = 128          # bytes: a view's offset in its allocation

# Sentinels of the guard bands, and the two prefills of the outputs.
_INT_OF = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
           torch.int32: torch.int32, torch.int64: torch.int64}
SENTINEL = {torch.float32: 0x7FA5A5A5, torch.bfloat16: 0x7FA5,
            torch.int32: 0x3FFFFFFF, torch.int64: 0x3FFFFFFFFFFFFFFF}
PREFILL_NAN = {torch.float32: 0x7FC0BEEF, torch.bfloat16: 0x7FC1}
# Large beside the cases' outputs, yet not so large that adding one of
# them leaves its bits (1e30 would absorb a sum read before its init).
PREFILL_LARGE = {torch.float32: 65536.5, torch.bfloat16: 1000.0}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One failed check: the case, the rule, and where (the kernel's
    source and the line of its definition)."""
    case: str
    rule: str
    message: str
    path: str = ""
    line: int = 0

    def format(self) -> str:
        return f"{self.path}:{self.line} {self.rule} [{self.case}] " \
               f"{self.message}"


@dataclasses.dataclass
class CaseResult:
    """What one case gave: its findings, the digest of its output (the
    InCRS orders are compared by it), the trips it ran and its note."""
    case: str
    wrapper: str
    findings: List[Finding]
    digest: str = ""
    trips: Optional[int] = None
    repeat: str = "bitwise"
    on_card: bool = False
    seconds: float = 0.0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["findings"] = [dataclasses.asdict(f) for f in self.findings]
        return d

    @staticmethod
    def from_json(d: dict) -> "CaseResult":
        d = dict(d)
        d["findings"] = [Finding(**f) for f in d["findings"]]
        return CaseResult(**d)


# ----------------------------------------------------------------------
# Guarded memory.
@dataclasses.dataclass
class Guarded:
    """A view inside an allocation with guard bands of ``lead`` and
    ``tail`` elements, each holding ``sentinel``."""
    alloc: torch.Tensor
    lead: int
    n: int
    view: torch.Tensor
    sentinel: int
    what: str

    def _bits(self) -> torch.Tensor:
        return self.alloc.view(_INT_OF[self.alloc.dtype])

    def damage(self) -> Tuple[int, int]:
        """(elements changed before the view, after it)."""
        bits = self._bits()
        before = int((bits[:self.lead] != self.sentinel).sum())
        after = int((bits[self.lead + self.n:] != self.sentinel).sum())
        return before, after


def _as_bits(value: int, dtype: torch.dtype) -> int:
    """``value`` as a signed integer of ``dtype``'s width."""
    width = torch.tensor([], dtype=dtype).element_size() * 8
    return value - (1 << width) if value >= 1 << (width - 1) else value


def guarded(shape: Sequence[int], dtype: torch.dtype, device, what: str,
            fill: Optional[int] = None) -> Guarded:
    """An uninitialised (or ``fill``-bits) view of ``shape`` at a
    ``GUARD_ALIGN``-byte offset, guard bands of a row of the last
    dimension (at least ``GUARD_ALIGN`` bytes) on each side."""
    shape = tuple(int(s) for s in shape)
    item = torch.tensor([], dtype=dtype).element_size()
    n = int(np.prod(shape)) if shape else 1
    row = (shape[-1] if shape else 1) * item
    band = max(GUARD_ALIGN, -(-row // GUARD_ALIGN) * GUARD_ALIGN) // item
    alloc = torch.empty(band + n + band + (-n % (GUARD_ALIGN // item)),
                        dtype=dtype, device=device)
    sent = _as_bits(SENTINEL[dtype], _INT_OF[dtype])
    bits = alloc.view(_INT_OF[dtype])
    bits[:band] = sent
    bits[band + n:] = sent
    if fill is not None:
        bits[band:band + n] = fill
    return Guarded(alloc, band, n, alloc[band:band + n].view(shape), sent,
                   what)


def _prefill_bits(pattern: str, dtype: torch.dtype) -> int:
    if pattern == "nan":
        return _as_bits(PREFILL_NAN[dtype], _INT_OF[dtype])
    return int(torch.tensor(PREFILL_LARGE[dtype], dtype=dtype)
               .view(_INT_OF[dtype]))


def _inputs(case: C.Case, device) -> Dict[str, Guarded]:
    out = {}
    cast = case.args.get("dtype", torch.float32)
    for name, arr in case.arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if t.is_floating_point():
            t = t.to(cast)
        g = guarded(t.shape, t.dtype, device, name)
        g.view.copy_(t.to(device))
        out[name] = g
    return out


# ----------------------------------------------------------------------
# Each wrapper, as ``ops`` calls it, and its plain version.
def _views(ins: Dict[str, Guarded]) -> Dict[str, torch.Tensor]:
    return {k: g.view for k, g in ins.items()}


def call_wrapper(case: C.Case, t: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One launch of ``case`` through its wrapper."""
    from ..kernels import bsr_spmm as B
    from ..kernels import dense_mm as D
    from ..kernels import flash_attention as F
    from ..kernels import incrs_gather as G
    from ..kernels import incrs_spmm as K
    from ..kernels import index_match_spmm as IM
    from ..spgemm import kernels as SK
    w, a, geo = case.wrapper, case.args, case.geometry
    if w in C.INCRS:
        return getattr(K, w)(t["idx"], t["val"], t["b"],
                             section=a["section"], bm=a["bm"], bn=a["bn"],
                             geometry=geo)
    if w == "incrs_gather":
        return G.incrs_gather(t["idx"], t["val"], section=a["section"],
                              bm=a["bm"], geometry=geo)
    if w in ("index_match_spmm", "spgemm_condense"):
        fn = IM.index_match_spmm if w == "index_match_spmm" \
            else SK.spgemm_condense
        return fn(t["a_idx"], t["a_val"], t["b_idx"], t["b_val"],
                  rounds=a["rounds"], bm=a["bm"], bn=a["bn"], geometry=geo)
    if w == "spgemm_merge":
        return SK.spgemm_merge(t["stripes"], bm=a["bm"], bn=a["bn"],
                               geometry=geo)
    if w == "dense_mm":
        return D.dense_mm(t["a"], t["b"]) if geo is None else \
            D._launch(t["a"], t["b"], geo)
    if w == "bsr_spmm":
        if geo is None:
            return B.bsr_spmm(t["row_of"], t["col_of"], t["values"],
                              t["b"], n_block_rows=a["n_block_rows"],
                              row_start=t["row_start"])
        return B._launch(t["col_of"], t["values"], t["b"], t["row_start"],
                         a["n_block_rows"], geo)
    with torch.no_grad():
        return F.flash_attention(t["q"], t["k"], t["v"],
                                 window=a["window"], soft_cap=a["soft_cap"],
                                 q_offset=a.get("q_offset", 0))


def call_plain(case: C.Case, t: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The plain version of ``case``'s wrapper on the same inputs."""
    from ..kernels import bsr_spmm as B
    from ..kernels import dense_mm as D
    from ..kernels import flash_attention as F
    from ..kernels import incrs_gather as G
    from ..kernels import incrs_spmm as K
    from ..kernels import index_match_spmm as IM
    from ..spgemm import kernels as SK
    w, a = case.wrapper, case.args
    if w in C.INCRS:
        return K.plain(w, t["idx"], t["val"], t["b"], section=a["section"],
                       bm=a["bm"], bn=a["bn"])
    if w == "incrs_gather":
        return G.plain(t["idx"], t["val"], section=a["section"], bm=a["bm"])
    if w == "index_match_spmm":
        return IM.plain(t["a_idx"], t["a_val"], t["b_idx"], t["b_val"],
                        rounds=a["rounds"], bm=a["bm"], bn=a["bn"])
    if w == "spgemm_condense":
        return SK.plain_condense(t["a_idx"], t["a_val"], t["b_idx"],
                                 t["b_val"], rounds=a["rounds"], bm=a["bm"],
                                 bn=a["bn"])
    if w == "spgemm_merge":
        return SK.plain_merge(t["stripes"], bm=a["bm"], bn=a["bn"])
    if w == "dense_mm":
        return D.plain(t["a"], t["b"])
    if w == "bsr_spmm":
        return B.plain(t["row_of"], t["col_of"], t["values"], t["b"],
                       n_block_rows=a["n_block_rows"])
    return F.plain(t["q"], t["k"], t["v"], window=a["window"],
                   soft_cap=a["soft_cap"], q_offset=a.get("q_offset", 0))


# ----------------------------------------------------------------------
def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(_INT_OF[t.dtype])


def _err(out: torch.Tensor, want: torch.Tensor, rowwise: bool
         ) -> torch.Tensor:
    """|out - want| over the scale: max|want| (per row where
    ``rowwise``), as a tensor of the elements' ratios."""
    o, w = out.double(), want.double()
    if rowwise and w.ndim:
        scale = w.abs().reshape(-1, w.shape[-1]).amax(-1, keepdim=True)
        scale = scale.expand(-1, w.shape[-1]).reshape(w.shape)
    else:
        scale = w.abs().max() if w.numel() else torch.zeros((), dtype=w.dtype)
    d = (o - w).abs()
    return torch.where(scale > 0, d / torch.clamp_min(scale, 1e-300),
                       torch.where(d > 0, torch.inf, 0.0))


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(_bits(t).cpu().numpy().tobytes()).hexdigest()[:16]


def _where(case: C.Case) -> Tuple[str, int]:
    """The kernel's source and the line of its definition."""
    try:
        symbol = case.launch().symbol[0]
    except ValueError:
        return f"src/repro_torch/kernels/csrc/{case.source}.cu", 0
    path = _build.CSRC / f"{case.source}.cu"
    if symbol.startswith("gemm_"):
        path = _build.CSRC / "gemm_sm90.cuh"
    for i, ln in enumerate(path.read_text().splitlines(), 1):
        if re.match(rf"\s*{re.escape(symbol)}\(", ln):
            return f"src/repro_torch/kernels/csrc/{path.name}", i
    return f"src/repro_torch/kernels/csrc/{path.name}", 0


def prove_case(case: C.Case, device, *,
               call: Callable = call_wrapper,
               plain: Callable = call_plain,
               repeats: int = 3) -> CaseResult:
    """Launch ``case`` ``repeats`` times (prefills NaN, large, NaN) on
    ``device`` through ``call`` and hold each against ``plain`` (the
    wrapper and its plain version unless a test gives fakes). With
    ``repeats`` = 1 (under the sanitizer) one launch and no comparison."""
    t0 = time.perf_counter()
    device = torch.device(device)
    path, line = _where(case)
    found: List[Finding] = []

    def find(rule, msg):
        if not any(f.rule == rule for f in found):
            found.append(Finding(case.id, rule, msg, path, line))

    ins = _inputs(case, device)
    runs = []
    for pattern in ("nan", "large", "nan")[:repeats]:
        outs: List[Guarded] = []

        def alloc(shape, dtype, dev, outs=outs, pattern=pattern):
            g = guarded(shape, dtype, dev, f"output {len(outs)}",
                        _prefill_bits(pattern, dtype))
            outs.append(g)
            return g.view
        with _alloc.outputs(alloc):
            out = call(case, _views(ins))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        for g in outs + list(ins.values()):
            before, after = g.damage()
            if before or after:
                find(RULE_OOB, f"the launch wrote {before} element(s) "
                     f"before and {after} after {g.what} ({pattern} "
                     f"prefill)")
        runs.append((pattern, out.detach().clone()))
    res = CaseResult(case.id, case.wrapper, found, digest(runs[0][1]),
                     case.trips, case.repeat, device.type == "cuda")
    if repeats == 1:
        res.seconds = time.perf_counter() - t0
        return res
    want = plain(case, _views(ins))
    if want.shape != runs[0][1].shape:
        find(RULE_UNVERIFIABLE, f"output shape {tuple(runs[0][1].shape)}, "
             f"plain {tuple(want.shape)}")
        res.seconds = time.perf_counter() - t0
        return res
    finite = torch.isfinite(want.float())
    (_, o1), (_, o2), (_, o3) = runs
    b1, b2, b3 = _bits(o1), _bits(o2), _bits(o3)
    kept1 = b1 == _prefill_bits("nan", o1.dtype)
    kept2 = b2 == _prefill_bits("large", o2.dtype)
    gap = kept1 & kept2 & finite
    if gap.any():
        find(RULE_COVERAGE, f"{int(gap.sum())} of {gap.numel()} output "
             f"elements kept their prefill")
    init = (b1 != b2) & ~(kept1 & kept2)
    if init.any():
        find(RULE_ACC_INIT, f"{int(init.sum())} output elements differ "
             f"between the NaN and the large prefill")
    for (pattern, o), kept in zip(runs[:2], (kept1, kept2)):
        bad = ~torch.isfinite(o.float()) & finite & ~kept
        if bad.any():
            find(RULE_OOB, f"{int(bad.sum())} non-finite output elements "
                 f"where the plain version is finite ({pattern} prefill): "
                 f"a read of a guard")
        err = _err(o, want, case.rowwise)
        off = (err > case.tol) & finite & torch.isfinite(o.float()) & ~kept
        if off.any():
            rule = RULE_DMA_READ if case.trips else RULE_ACC_FLUSH
            find(rule, f"{int(off.sum())} output elements off the plain "
                 f"version, worst {float(err[off].max()):.3g} > "
                 f"{case.tol:g} of max|plain| ({pattern} prefill"
                 f"{f', {case.trips} ring trips' if case.trips else ''})")
    if case.repeat == "bitwise":
        if not torch.equal(b1, b3):
            find(RULE_RACE, f"a repeat launch gave other bits in "
                 f"{int((b1 != b3).sum())} elements")
    else:
        worst = float(_err(o3, o1, case.rowwise).max()) if o1.numel() else 0
        if worst > case.tol:
            find(RULE_RACE, f"a repeat launch is off the first by {worst:.3g}"
                 f" > {case.tol:g} ({case.repeat})")
    res.seconds = time.perf_counter() - t0
    return res


# ----------------------------------------------------------------------
# The children, the watchdog and the matrix.
def family_main(argv=None) -> int:
    """``python -m repro_torch.analysis.proofs --family F``: a child that
    runs one family's cases from ``--start``, a JSON line before each
    case ({"start": id}) and after it ({"result": ...})."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.proofs")
    ap.add_argument("--family", required=True, choices=C.FAMILIES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--once", action="store_true",
                    help="one launch a case, nothing compared (under the "
                         "sanitizer)")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for case in C.family_cases(args.family, seed=args.seed)[args.start:]:
        print(json.dumps({"start": case.id}), flush=True)
        res = prove_case(case, args.device, repeats=1 if args.once else 3)
        print(json.dumps({"result": res.to_json()}), flush=True)
    return 0


def watch(cmd: Sequence[str], ids: Sequence[str], ring: Dict[str, bool],
          timeout: float = WATCHDOG_S, env=None) -> List[CaseResult]:
    """Run the child ``cmd`` (its ``--start`` appended) under a watchdog
    of ``timeout`` s; a case it starts and never finishes is a finding
    (``dma-wait-without-start`` for a ring case that hangs,
    ``grid-oob-access`` for a fault, ``grid-unverifiable`` otherwise), and
    the child resumes after it."""
    results: List[CaseResult] = []
    start = 0
    while start < len(ids):
        proc = subprocess.Popen([*cmd, "--start", str(start)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
        hung = False
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            hung = True
        started = None
        for ln in out.splitlines():
            try:
                msg = json.loads(ln)
            except json.JSONDecodeError:
                continue
            if "start" in msg:
                started = msg["start"]
            elif "result" in msg:
                results.append(CaseResult.from_json(msg["result"]))
                started = None
        if not hung and proc.returncode == 0:
            break
        why = f"no result within the {timeout:.0f} s watchdog" if hung \
            else f"the child exited {proc.returncode}: " \
                 f"{err.strip()[-300:]}"
        if started is None:             # it ended outside any case
            done = {r.case for r in results}
            for cid in ids[start:]:
                if cid not in done:
                    results.append(CaseResult(
                        cid, cid.split("/")[0],
                        [Finding(cid, RULE_UNVERIFIABLE, why)],
                        on_card=True))
            break
        rule = (RULE_DMA_WAIT if ring.get(started) else RULE_UNVERIFIABLE) \
            if hung else RULE_OOB
        results.append(CaseResult(started, started.split("/")[0],
                                  [Finding(started, rule, why)],
                                  on_card=True))
        start = ids.index(started) + 1
    return results


def run(device: str = "cuda", *, seed: int = 0,
        families: Sequence[str] = C.FAMILIES,
        timeout: float = WATCHDOG_S) -> List[CaseResult]:
    """Every case of ``families`` on the card ``device``: one child a
    family, all at once, each under the watchdog."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"the proofs launch the kernels: a CUDA device, "
                         f"not {device}")
    _build.build_all()
    env = dict(os.environ)
    src = str(_build.CSRC.parents[2])
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")

    def one(family):
        cs = C.family_cases(family, seed=seed)
        cmd = [sys.executable, "-m", "repro_torch.analysis.proofs",
               "--family", family, "--seed", str(seed), "--device", device]
        return watch(cmd, [c.id for c in cs],
                     {c.id: c.trips is not None for c in cs}, timeout, env)
    with ThreadPoolExecutor(max_workers=len(families)) as pool:
        return [r for rs in pool.map(one, families) for r in rs]


def cross_order(results: Sequence[CaseResult]) -> List[Finding]:
    """The three InCRS orders must agree bit for bit on every case they
    all took (``parallel-axis-race`` on the one that differs)."""
    by: Dict[str, Dict[str, str]] = {}
    for r in results:
        if r.wrapper in C.INCRS and not r.findings:
            by.setdefault(r.case.split("/", 1)[1], {})[r.wrapper] = r.digest
    out = []
    for name, ds in by.items():
        if len(set(ds.values())) > 1:
            ref = ds.get("incrs_spmm")
            for w, d in ds.items():
                if ref is not None and d != ref:
                    out.append(Finding(
                        f"{w}/{name}", RULE_RACE, f"{w} and incrs_spmm give "
                        f"other bits at one geometry", "", 0))
    return out


def _na(kernel: str, prop: str, results: Sequence[CaseResult]
        ) -> Optional[str]:
    if prop == "dma" and not any(r.trips for r in results
                                 if r.wrapper == kernel):
        return "n/a (no asynchronous copy ring)"
    return None


def proof_matrix(results: Sequence[CaseResult],
                 extra: Sequence[Finding] = ()
                 ) -> Dict[str, Dict[str, str]]:
    """{kernel: {property: status}}: ``proved`` where every case of the
    kernel ran on the card with no finding of the property's rules,
    ``n/a (...)`` where the property does not apply, the first finding's
    rule where one fired; ``untested`` where no case ran on the card."""
    findings = [f for r in results for f in r.findings] + list(extra)
    matrix: Dict[str, Dict[str, str]] = {}
    for k in KERNELS:
        mine = [r for r in results if r.wrapper == k]
        row = {}
        for p in PROPERTIES:
            na = _na(k, p, mine)
            hit = [f for f in findings if f.case.split("/")[0] == k and
                   f.rule in _PROP_RULES[p]]
            if not mine or not all(r.on_card for r in mine):
                row[p] = "untested"
            elif hit:
                row[p] = hit[0].rule
            else:
                row[p] = na or "proved"
        matrix[k] = row
    return matrix


def format_proof_matrix(matrix: Dict[str, Dict[str, str]]) -> str:
    name_w = max(len(k) for k in matrix) + 2
    col_w = max(max(len(p) for p in PROPERTIES),
                max(len(v) for row in matrix.values()
                    for v in row.values())) + 2
    lines = [" " * name_w + "".join(p.ljust(col_w) for p in PROPERTIES)]
    for k, row in matrix.items():
        lines.append(k.ljust(name_w) +
                     "".join(row[p].ljust(col_w) for p in PROPERTIES))
    return "\n".join(lines)


if __name__ == "__main__":
    sys.exit(family_main())
