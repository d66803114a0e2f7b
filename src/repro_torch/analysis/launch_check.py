"""Launch checks: prove a kernel launch fits the card before it runs.

The Hopper counterpart of the launch half of ``repro.analysis.kernel_check``
and ``repro.analysis.vmem``. Where the JAX package models VMEM footprints
of Pallas grids, the port's kernels are launched from geometries that
their wrappers compute (the one source of each launch); this module reads
those geometries, never re-deriving their arithmetic, and holds each
against what the card and the kernel's source take:

* ``geometry``       — a geometry handed in (a tuned or swept launch) is
  the one the wrapper builds from its knobs at this shape, so a launch
  tuned for another shape never runs here;
* ``instance``       — the instance exists in the kernel's ``.cu``
  dispatch (a template instance or an ``enum Instance`` case, and the
  launcher's own ranges);
* ``shared-memory``  — dynamic shared memory <= ``SMEM_LIMIT`` (227 KB);
* ``grid``           — the grid, block and cluster fit the card's limits
  (``bsr_spmm``'s column-tile grid of the general instance is one case);
* ``registers``      — registers a thread from the ptxas log of the build
  (``build/repro_torch_kernels/*.log``): at most 255, and one CTA's warps
  must fit the register file (4 partitions of 16,384, 256-register units
  a warp); skipped, with a note, where there is no log
  (a machine that has not built the kernels, as the CPU tests run);
* ``occupancy``      — on the card only: the CTAs an SM that the occupancy
  calculator gives (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)
  against what the wrapper counts on; skipped, with a note, without one.

``check_launch(name, **shape)`` covers every wrapper (``WRAPPERS``);
``check_incrs_config``/``require_feasible`` and ``check_matched_config``
keep the JAX names for the InCRS orders and the matched family.
``LAUNCH_RULES`` is the set the autotuner, ``sparse.plan`` and the serving
engine gate a launch on. The JAX package's DMA-pairing and grid-interpreter
proofs read Pallas source and have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import functools
import logging
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..kernels import _build
from ..kernels import bsr_spmm as _bsr
from ..kernels import dense_mm as _dense
from ..kernels import flash_attention as _flash
from ..kernels import incrs_gather as _gather
from ..kernels import incrs_spmm as _incrs
from ..kernels import index_match_spmm as _im
from ..kernels import _gemm

log = logging.getLogger(__name__)

RULE_SHAPE = "geometry"
RULE_INSTANCE = "instance"
RULE_SMEM = "shared-memory"
RULE_GRID = "grid"
RULE_REGISTERS = "registers"
RULE_OCCUPANCY = "occupancy"

LAUNCH_RULES = (RULE_SHAPE, RULE_INSTANCE, RULE_SMEM, RULE_GRID,
                RULE_REGISTERS, RULE_OCCUPANCY)

RULES: Dict[str, str] = {
    RULE_SHAPE: "the geometry is not this shape's launch of its knobs",
    RULE_INSTANCE: "the instance is not in the kernel's .cu dispatch",
    RULE_SMEM: "dynamic shared memory over what one block may use",
    RULE_GRID: "grid, block or cluster outside the card's limits",
    RULE_REGISTERS: "registers (ptxas) do not fit one CTA on an SM",
    RULE_OCCUPANCY: "the card holds fewer CTAs an SM than the wrapper "
                    "counts on",
}

SMEM_LIMIT = _incrs.SMEM_LIMIT
GRID_X_MAX = 2 ** 31 - 1
GRID_YZ_MAX = 65_535
BLOCK_THREADS_MAX = 1024
CLUSTER_MAX = 8                 # the portable cluster size
REGISTERS_MAX = 255

MATCHED_KERNEL = {"index_match": "index_match_spmm",
                  "condense": "spgemm_condense", "merge": "spgemm_merge"}


@dataclasses.dataclass(frozen=True)
class Violation:
    """One reason a launch cannot (or should not) run: the rule that
    fired, the term it concerns, and the amount against its limit."""
    rule: str
    message: str
    term: Optional[str] = None
    nbytes: Optional[int] = None
    limit: Optional[int] = None

    def format(self) -> str:
        extra = ""
        if self.nbytes is not None and self.limit is not None:
            extra = f" ({self.nbytes} > {self.limit})"
        return f"{self.rule}: {self.message}{extra}"


class KernelConfigError(ValueError):
    """A launch provably violates a rule. Raised before any launch, with
    the structured violations on ``.violations``."""

    def __init__(self, violations: Sequence[Violation], context: str = ""):
        self.violations = tuple(violations)
        head = context + ": " if context else ""
        body = "; ".join(v.format() for v in self.violations) \
            or "infeasible kernel launch"
        super().__init__(head + body)


@dataclasses.dataclass(frozen=True)
class Launch:
    """What one launch of a wrapper's kernel is, read off its geometry."""
    name: str
    geometry: Any
    source: str                         # csrc/<source>.cu
    tokens: Tuple[str, ...]             # what the dispatch must hold
    limits: Tuple[Tuple[str, int, int], ...]   # (what, value, C's maximum)
    symbol: Tuple[str, Optional[str]]   # ptxas entry: name, template args
    threads: int
    smem: int
    grid: Tuple[int, int, int]          # x, y, cluster
    ctas_per_sm: Callable[[Optional[int]], int]   # the wrapper's count,
                                        # given registers a thread
    card_ctas: Callable[[], int]        # the occupancy calculator's
    rebuild: Callable[[], Any]          # the wrapper's launch of the
                                        # geometry's knobs at this shape


@dataclasses.dataclass
class LaunchReport:
    """``check_launch``'s whole answer: the launch (None where the wrapper
    refused the shape), the violations, the rules skipped and why, and
    what the log and the card said."""
    launch: Optional[Launch]
    violations: List[Violation]
    notes: List[str]
    registers: Optional[int] = None
    spill_bytes: Optional[int] = None
    assumed_ctas: Optional[int] = None
    card_ctas: Optional[int] = None


# ----------------------------------------------------------------------
# The ptxas log of a build and the dispatch of a source.
def short_name(sym: str) -> str:
    """``reuse_kernel<128>`` from an Itanium-mangled kernel symbol (in a
    namespace or not); template arguments kept only where all are
    integer or bool literals."""
    m = re.match(r"_Z(N?)", sym)
    if not m:
        return sym
    i, names = m.end(), []
    while i < len(sym) and sym[i].isdigit():
        j = i
        while sym[j].isdigit():
            j += 1
        names.append(sym[j:j + int(sym[i:j])])
        i = j + int(sym[i:j])
        if not m.group(1):
            break
    if not names:
        return sym
    targs = re.match(r"I((?:L[ib]\d+E)+)E", sym[i:])
    args = re.findall(r"L[ib](\d+)E", targs.group(1)) if targs else []
    return names[-1] + (f"<{','.join(args)}>" if args else "")


def ptxas_kernels(log_text: str) -> List[dict]:
    """Registers and spill bytes of each kernel in a ``-Xptxas=-v`` log."""
    out, cur = [], None
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"kernel": short_name(m.group(1)), "registers": None,
                   "spill_stores": None, "spill_loads": None}
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int,
                                                               m.groups())
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"] = int(m.group(1))
    return out


@functools.lru_cache(maxsize=None)
def _source_text(source: str) -> str:
    return (_build.CSRC / f"{source}.cu").read_text()


@functools.lru_cache(maxsize=None)
def _enum_ids(source: str) -> Dict[str, int]:
    body = _source_text(source).split("enum Instance")[1].split("};")[0]
    return {k.lower(): int(v) for k, v in
            re.findall(r"\b([A-Z0-9_]+) = (\d+)", body)}


_PTXAS: Dict[str, tuple] = {}       # source -> its build's ptxas entries
_BUILT: set = set()                 # sources built in this process


def _ensure_built(source: str) -> None:
    """Build ``source`` once a process (its log comes with the build)."""
    if source not in _BUILT:
        _build.build_all([source])
        _BUILT.add(source)


def _ptxas_table(source: str) -> tuple:
    """The ptxas entries of ``source``'s build, read once a process; an
    absent log is read again on the next call (a build may follow)."""
    hit = _PTXAS.get(source)
    if hit is None:
        hit = tuple(ptxas_kernels(_build.build_log(source)))
        if hit:
            _PTXAS[source] = hit
    return hit


def _log_registers(source: str, symbol: Tuple[str, Optional[str]]
                   ) -> Optional[Tuple[int, int]]:
    """(registers, spill store bytes) of the kernel ``symbol`` in the last
    build's ptxas log of ``source``, the most over its instantiations;
    None where there is no log or no such entry."""
    base, args = symbol
    found = None
    for k in _ptxas_table(source):
        name = k["kernel"]
        kb, _, ka = name.partition("<")
        if kb != base or (args is not None and ka.rstrip(">") != args):
            continue
        if k["registers"] is None:
            continue
        regs, spill = k["registers"], k["spill_stores"] or 0
        found = (max(found[0], regs), max(found[1], spill)) if found \
            else (regs, spill)
    return found


# ----------------------------------------------------------------------
# Each wrapper's launch, from its own geometry function.
def _incrs_launch(name, geometry, *, m, n, n_sections, smax, section,
                  **knobs) -> Launch:
    geo = geometry or _incrs.launch_geometry(name, n, smax, section, m=m,
                                             **knobs)
    threads = _incrs.launch_threads(name, geo)
    smem = geo.smem if name == "incrs_spmm_pipelined" else geo[1]
    inst = _incrs.instance_of(name, geo, n)
    if name == "incrs_spmm":
        tokens = (f"expand_kernel<{'true' if inst else 'false'}>",)
        limits = (("rows a CTA", geo[0], 8),)
        symbol = ("expand_kernel", str(inst))
    elif name == "incrs_spmm_reuse":
        tokens = (f"reuse_kernel<{inst}>", f"tpr != {inst}")
        limits = ()
        symbol = ("reuse_kernel", str(inst))
    else:
        tokens = (f"launch_pipelined<{inst}>",)
        limits = (("consumer warps", geo.warps, _incrs.PIPE_MAX_WARPS),
                  ("box rows", geo.box_rows, _incrs.TMA_BOX_MAX))
        symbol = ("pipelined_kernel", str(inst))
    return Launch(
        name, geo, "incrs_spmm", tokens, limits, symbol, threads, smem,
        _incrs.launch_grid(name, geo, m, n),
        lambda regs: _incrs.assumed_ctas_per_sm(name, geo, regs),
        lambda: _incrs.ctas_per_sm(name, geo, n),
        lambda: _incrs.rebuild(name, geo, m=m, n=n, smax=smax,
                               section=section))


def _gather_launch(name, geometry, *, m, n_sections, smax, section,
                   **knobs) -> Launch:
    geo = geometry or _gather.gather_geometry(m, n_sections, smax, section,
                                              **knobs)
    tile = geo.instance == "tile"
    return Launch(
        name, geo, "incrs_gather",
        (f"{geo.instance.upper()} = {_gather.INSTANCES.index(geo.instance)}",),
        (), ("tile_kernel" if tile else "gather_kernel", None),
        geo.threads, geo.smem, (geo.grid, 1, 1),
        lambda regs: geo.ctas_per_sm if tile else 1,
        lambda: _gather.ctas_per_sm(geo),
        lambda: _gather.gather_geometry(m, n_sections, smax, section,
                                        instance=geo.instance,
                                        sections=geo.sections or None))


def _match_launch(name, geometry, *, m, n, n_rounds, rmax_a, rmax_b, rounds,
                  **knobs) -> Launch:
    geo = geometry or _im.match_geometry(m, n, n_rounds, rmax_a, rmax_b,
                                         rounds, name, **knobs)
    ring = geo.instance == "ring"
    grid = (geo.grid, 1, 1) if ring else (geo.col_tiles, geo.row_tiles, 1)
    limits = ((("rows a warp", geo.rows_per_warp,
                _im.RING_MAX_ROWS_PER_WARP),
               ("round window", rounds, _im.RING_MAX_ROUNDS))
              if ring else ())
    return Launch(
        name, geo, "index_match",
        (f"{geo.instance.upper()} = {_im.INSTANCES.index(geo.instance)}",),
        limits, ("ring_kernel" if ring else "match_kernel",
                 str(int(geo.stripes))),
        geo.threads, geo.smem, grid,
        lambda regs: _im.assumed_ctas(geo),
        lambda: _im.ctas_per_sm(geo),
        lambda: _im.match_geometry(
            m, n, n_rounds, rmax_a, rmax_b, rounds, name,
            instance=geo.instance, rows_per_warp=geo.rows_per_warp or None,
            stages=geo.stages or None, chunk=geo.chunk or None))


def _merge_launch(name, geometry, *, plane, n_rounds, aligned=True,
                  **knobs) -> Launch:
    from ..spgemm import kernels as _sk        # circular at module scope
    geo = geometry or _sk.merge_geometry(plane, n_rounds, aligned, **knobs)
    ring = geo.instance == "ring"
    return Launch(
        name, geo, "index_match",
        (f"{geo.instance.upper()} = "
         f"{_sk.MERGE_INSTANCES.index(geo.instance)}",),
        (("chunk floats", geo.chunk, _sk.MERGE_MAX_CHUNK),) if ring else (),
        ("merge_ring_kernel" if ring else "merge_kernel", None),
        geo.threads, geo.smem, (geo.grid, 1, 1),
        lambda regs: _sk.merge_ctas(geo.smem) if ring else 1,
        lambda: _sk.merge_ctas_per_sm(geo),
        lambda: _sk.merge_geometry(plane, n_rounds, aligned,
                                   instance=geo.instance,
                                   chunk=geo.chunk or None,
                                   stages=geo.stages or None))


def _gemm_tokens(geo) -> Tuple[str, ...]:
    tokens = [f"case {geo.instance.upper()}:"]
    if geo.instance == "bf16_wgmma":
        tokens.append(f"kBf16Bk, {geo.tile_n}>")
    if geo.layout:
        tokens.append(f"bsr_kernel<{geo.layout[0]}, T>")
    return tuple(tokens)


def _gemm_symbol(geo, general: str) -> Tuple[str, Optional[str]]:
    if geo.instance == "f32_fma":
        return "gemm_f32_kernel", None
    if geo.instance == "bf16_wgmma":
        return "gemm_bf16_kernel", None
    return general, None


def _gemm_knobs(geo, aligned: bool) -> dict:
    """gemm_geometry's arguments that rebuild ``geo``: a fast instance's
    splits, stages and tile columns; the general one as the unaligned
    operands' launch."""
    if geo.stages:
        return dict(aligned=aligned, splits=geo.splits, stages=geo.stages,
                    tile_n=geo.tile_n)
    return dict(aligned=False)


def _gemm_grid(geo) -> Tuple[int, int, int]:
    if geo.stages:                              # fast: tiles x K splits
        return geo.tiles, geo.splits, 1
    return geo.col_tiles, geo.row_tiles, 1      # dense general


def _dense_launch(name, geometry, *, m, n, k, dtype=torch.float32,
                  aligned=True, **knobs) -> Launch:
    geo = geometry or _dense.gemm_geometry(m, n, k, dtype, aligned=aligned,
                                           **knobs)
    return Launch(
        name, geo, "dense_mm", _gemm_tokens(geo), (),
        _gemm_symbol(geo, "dense_kernel"), geo.threads, geo.smem,
        _gemm_grid(geo), lambda regs: _gemm.CTAS_PER_SM.get(geo.instance, 1),
        lambda: _dense.ctas_per_sm(geo),
        lambda: _dense.gemm_geometry(m, n, k, dtype, **_gemm_knobs(geo,
                                                                  aligned)))


def _bsr_launch(name, geometry, *, n_block_rows, bm, bk, n, nnz,
                dtype=torch.float32, aligned=True, **knobs) -> Launch:
    geo = geometry or _bsr.gemm_geometry(n_block_rows, bm, bk, n, dtype,
                                         nnz=nnz, aligned=aligned, **knobs)
    grid = _gemm_grid(geo) if geo.stages else \
        (geo.row_tiles, geo.col_tiles, 1)       # bsr general: column tiles
    return Launch(                              # on the grid's y
        name, geo, "bsr_spmm", _gemm_tokens(geo), (),
        _gemm_symbol(geo, "bsr_kernel"), geo.threads, geo.smem, grid,
        lambda regs: _gemm.CTAS_PER_SM.get(geo.instance, 1),
        lambda: _bsr.ctas_per_sm(geo),
        lambda: _bsr.gemm_geometry(n_block_rows, bm, bk, n, dtype, nnz=nnz,
                                   **_gemm_knobs(geo, aligned)))


def _flash_launch(name, geometry, *, batch, sq, sk, kv, g, hd,
                  dtype=torch.bfloat16, window=None) -> Launch:
    def plan():
        q = torch.empty((batch, sq, kv, g, hd), dtype=dtype, device="meta")
        k = torch.empty((batch, sk, kv, hd), dtype=dtype, device="meta")
        return _flash.plan(q, k, k, window)
    launch = geometry or plan()
    nj = -(-hd // 64)
    bf16 = launch.route == "bf16_wgmma"
    inst = 64 * nj if bf16 else nj
    kind = "bf16" if bf16 else "f32"
    return Launch(
        name, launch, "flash_attention", (f"launch_{kind}<{inst}>",),
        (("head dim", hd, _flash.HD_MAX),),
        (f"flash_kernel_{kind}", str(inst)),
        256, launch.smem, (batch * kv * g * launch.n_qt, 1, 1),
        lambda regs: 1, lambda: _flash.ctas_per_sm(launch, hd), plan)


_LAUNCHERS: Dict[str, Callable[..., Launch]] = {
    "incrs_spmm": _incrs_launch, "incrs_spmm_reuse": _incrs_launch,
    "incrs_spmm_pipelined": _incrs_launch, "incrs_gather": _gather_launch,
    "index_match_spmm": _match_launch, "spgemm_condense": _match_launch,
    "spgemm_merge": _merge_launch, "dense_mm": _dense_launch,
    "bsr_spmm": _bsr_launch, "flash_attention": _flash_launch}


WRAPPERS = tuple(_LAUNCHERS)


def launch_of(name: str, geometry=None, **shape) -> Launch:
    """The launch of wrapper ``name`` at ``shape`` (its geometry
    function's arguments), at ``geometry`` where given, else at the
    geometry the wrapper computes (raises ValueError where it refuses)."""
    if name not in _LAUNCHERS:
        raise ValueError(f"launch_check: unknown wrapper {name!r}; expected "
                         f"one of {sorted(_LAUNCHERS)}")
    return _LAUNCHERS[name](name, geometry, **shape)


# ----------------------------------------------------------------------
def refusal(name: str, err: ValueError) -> Violation:
    """A wrapper's own refusal of a shape, by the rule it concerns."""
    msg = str(err)
    if not msg.startswith(name):
        msg = f"{name}: {msg}"
    rule = RULE_SMEM if "shared memory" in msg else \
        RULE_GRID if ("grid" in msg or "range" in msg or "int32" in msg) \
        else RULE_INSTANCE
    return Violation(rule, msg)


_NOTED: set = set()


def _note(notes: List[str], text: str) -> None:
    notes.append(text)
    if text not in _NOTED:
        _NOTED.add(text)
        log.info("launch_check: %s", text)


def _rules_on(launch: Launch, rules: Sequence[str], on_card: bool,
              given: bool) -> LaunchReport:
    out: List[Violation] = []
    notes: List[str] = []
    rep = LaunchReport(launch, out, notes)
    want = set(rules)
    name = launch.name
    if RULE_SHAPE in want and given:
        try:
            own = launch.rebuild()
        except ValueError as err:
            own = err
        if own != launch.geometry:
            out.append(Violation(
                RULE_SHAPE, f"{name}: geometry {tuple(launch.geometry)} is "
                f"not this shape's launch of its knobs ({own})",
                term="geometry"))
    if RULE_INSTANCE in want:
        text = _source_text(launch.source)
        if launch.source in ("incrs_gather", "index_match"):
            ids = _enum_ids(launch.source)
            for tok in launch.tokens:
                key, _, val = tok.partition(" = ")
                if ids.get(key.lower()) != int(val):
                    out.append(Violation(
                        RULE_INSTANCE, f"{name}: instance {key.lower()} is "
                        f"not id {val} of {launch.source}.cu's enum "
                        f"Instance", term=key.lower()))
        else:
            for tok in launch.tokens:
                if tok not in text:
                    out.append(Violation(
                        RULE_INSTANCE, f"{name}: {launch.source}.cu has no "
                        f"{tok!r} for this launch", term=tok))
        for what, value, top in launch.limits:
            if not 1 <= value <= top:
                out.append(Violation(
                    RULE_INSTANCE, f"{name}: {what} {value} outside the "
                    f"kernel's 1..{top}", term=what, nbytes=value,
                    limit=top))
    if RULE_SMEM in want and launch.smem > SMEM_LIMIT:
        out.append(Violation(
            RULE_SMEM, f"{name}: {launch.smem} bytes of dynamic shared "
            f"memory a block", term="smem", nbytes=launch.smem,
            limit=SMEM_LIMIT))
    if RULE_GRID in want:
        x, y, cluster = launch.grid
        for what, value, top in (("grid x", x, GRID_X_MAX),
                                 ("grid y", y, GRID_YZ_MAX),
                                 ("threads a block", launch.threads,
                                  BLOCK_THREADS_MAX),
                                 ("cluster", cluster, CLUSTER_MAX)):
            if not 1 <= value <= top:
                out.append(Violation(
                    RULE_GRID, f"{name}: {what} {value} outside 1..{top}",
                    term=what, nbytes=value, limit=top))
        if cluster > 1 and x % cluster:
            out.append(Violation(
                RULE_GRID, f"{name}: grid x {x} is not a multiple of the "
                f"cluster {cluster}", term="cluster"))
    regs = None
    if RULE_REGISTERS in want or RULE_OCCUPANCY in want:
        if on_card:
            _ensure_built(launch.source)
        found = _log_registers(launch.source, launch.symbol)
        if found is None:
            _note(notes, f"{RULE_REGISTERS}: no ptxas log of "
                  f"{launch.source}.cu ({launch.symbol[0]}) in "
                  f"{_build.BUILD_DIR}; rule skipped")
        else:
            regs, rep.spill_bytes = found
            rep.registers = regs
            warps = -(-launch.threads // 32)
            fit = _incrs.warps_by_registers(regs)
            if RULE_REGISTERS in want and (regs > REGISTERS_MAX or
                                           warps > fit):
                out.append(Violation(
                    RULE_REGISTERS, f"{name}: {regs} registers a thread "
                    f"hold {fit} warps an SM, a CTA has {warps}",
                    term="registers", nbytes=warps, limit=fit))
    if RULE_OCCUPANCY in want:
        rep.assumed_ctas = launch.ctas_per_sm(regs)
        if not on_card:
            _note(notes, f"{RULE_OCCUPANCY}: no CUDA card; rule skipped")
        elif not out:
            rep.card_ctas = launch.card_ctas()
            if rep.card_ctas < max(1, rep.assumed_ctas):
                out.append(Violation(
                    RULE_OCCUPANCY, f"{name}: the card holds "
                    f"{rep.card_ctas} CTAs an SM, the wrapper counts on "
                    f"{rep.assumed_ctas}", term="ctas_per_sm",
                    nbytes=rep.card_ctas, limit=rep.assumed_ctas))
    return rep


@functools.lru_cache(maxsize=4096)
def _report(name: str, geometry, shape: Tuple, rules: Tuple[str, ...],
            on_card: bool) -> LaunchReport:
    try:
        launch = launch_of(name, geometry, **dict(shape))
    except ValueError as err:
        return LaunchReport(None, [refusal(name, err)], [])
    return _rules_on(launch, rules, on_card, geometry is not None)


def launch_report(name: str, *, geometry=None,
                  rules: Optional[Sequence[str]] = None,
                  on_card: Optional[bool] = None, **shape) -> LaunchReport:
    """The whole check of one launch of wrapper ``name`` (see
    ``check_launch``), with the notes of skipped rules, the registers and
    spills the log gave, and the CTAs an SM counted and measured.
    Memoized per (launch, rules); a build in between is not seen."""
    if name not in _LAUNCHERS:
        raise ValueError(f"launch_check: unknown wrapper {name!r}; expected "
                         f"one of {sorted(_LAUNCHERS)}")
    rules = tuple(LAUNCH_RULES if rules is None else rules)
    if on_card is None:
        on_card = torch.cuda.is_available()
    return _report(name, geometry, tuple(sorted(shape.items())), rules,
                   bool(on_card))


def check_launch(name: str, *, geometry=None,
                 rules: Optional[Sequence[str]] = None,
                 on_card: Optional[bool] = None, **shape) -> List[Violation]:
    """Every violation of one launch of wrapper ``name`` (``WRAPPERS``) at
    ``shape`` — the keyword arguments of its geometry function: ``m, n,
    n_sections, smax, section`` for the InCRS orders; ``m, n_sections,
    smax, section`` for the gather; ``m, n, n_rounds, rmax_a, rmax_b,
    rounds`` for index matching and condense; ``plane, n_rounds[,
    aligned]`` for merge; ``m, n, k, dtype`` for dense; ``n_block_rows,
    bm, bk, n, nnz, dtype`` for BSR; ``batch, sq, sk, kv, g, hd, dtype[,
    window]`` for flash attention — and the geometry's knobs. ``geometry``
    is held as given; without it, the wrapper's own (a shape it refuses is
    one violation). ``rules`` restricts the rules (default
    ``LAUNCH_RULES``); ``on_card`` (default: whether CUDA is available)
    runs the occupancy rule."""
    return list(launch_report(name, geometry=geometry, rules=rules,
                              on_card=on_card, **shape).violations)


def require_launch(name: str, *, context: str = "", **kw) -> None:
    """Raise ``KernelConfigError`` where ``check_launch`` finds any
    violation."""
    vs = check_launch(name, **kw)
    if vs:
        raise KernelConfigError(vs, context=context or name)


# ----------------------------------------------------------------------
# The JAX names.
def check_incrs_config(variant: str, *, m: int, n: int, n_sections: int,
                       smax: int, section: int, k: Optional[int] = None,
                       geometry=None,
                       rules: Optional[Sequence[str]] = None,
                       on_card: Optional[bool] = None) -> List[Violation]:
    """Every violation of one launch of the InCRS order ``variant`` at M
    (padded) rows, N columns and (n_sections, smax) stripes of
    ``section``; ``k`` (B's rows) must be n_sections * section."""
    if variant not in _incrs.ORDERS:
        raise ValueError(f"unknown variant {variant!r}")
    out = []
    if k is not None and k != n_sections * section:
        out.append(Violation(
            RULE_GRID, f"dense operand has {k} rows, the stripes describe "
            f"{n_sections} x {section} = {n_sections * section}"))
    return out + check_launch(_incrs.ORDERS[variant], geometry=geometry,
                              rules=rules, on_card=on_card, m=m, n=n,
                              n_sections=n_sections, smax=smax,
                              section=section)


def require_feasible(variant: str, *, context: str = "", **kw) -> None:
    """Raise ``KernelConfigError`` where ``check_incrs_config`` finds any
    violation."""
    vs = check_incrs_config(variant, **kw)
    if vs:
        raise KernelConfigError(vs, context=context)


def check_matched_config(stage: str, *, m: int, n: int, n_rounds: int,
                         rmax_a: int, rmax_b: int, rounds: int,
                         geometry=None,
                         rules: Optional[Sequence[str]] = None,
                         on_card: Optional[bool] = None) -> List[Violation]:
    """Every violation of one launch of the matched-family stage
    ``"index_match"``, ``"condense"`` or ``"merge"`` on A (m, n_rounds,
    rmax_a) and B (n, n_rounds, rmax_b) with windows of ``rounds`` (merge:
    its (n_rounds, m, n) stripes)."""
    if stage not in MATCHED_KERNEL:
        raise ValueError(f"unknown matched stage {stage!r}; expected "
                         f"'index_match', 'condense' or 'merge'")
    out = []
    if max(rmax_a, rmax_b) > rounds:
        out.append(Violation(
            RULE_GRID, f"rmax={max(rmax_a, rmax_b)} exceeds rounds={rounds}:"
            f" a round window cannot hold more non-zeros than slots"))
    name = MATCHED_KERNEL[stage]
    if stage == "merge":
        return out + check_launch(name, geometry=geometry, rules=rules,
                                  on_card=on_card, plane=m * n,
                                  n_rounds=n_rounds)
    return out + check_launch(name, geometry=geometry, rules=rules,
                              on_card=on_card, m=m, n=n, n_rounds=n_rounds,
                              rmax_a=rmax_a, rmax_b=rmax_b, rounds=rounds)


__all__ = ["LAUNCH_RULES", "RULES", "WRAPPERS", "Violation",
           "KernelConfigError", "Launch", "LaunchReport", "launch_of",
           "launch_report", "check_launch", "require_launch", "refusal",
           "check_incrs_config", "require_feasible", "check_matched_config",
           "ptxas_kernels", "short_name"]
