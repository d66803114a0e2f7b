"""The kernel families' cases under ``compute-sanitizer``.

Where the card's CUDA toolkit has ``compute-sanitizer``, each family's
cases (``analysis.cases``, one launch a case: ``proofs --once``) run under
each of its four tools, one child process a family and tool, each with a
timeout, instrumenting only the family's own kernels (``--kernel-regex``)
so that torch's kernels do not cost the run:

* ``memcheck``  -> ``grid-oob-access`` (an access outside any allocation,
  a misaligned one, a fault);
* ``racecheck`` -> ``parallel-axis-race`` (a shared-memory hazard);
* ``synccheck`` -> ``dma-wait-without-start`` (a barrier misused, the
  rings' mbarriers included as far as the tool models them);
* ``initcheck`` -> ``acc-init-gap`` (a read of device memory never
  written).

The report is parsed into ``proofs.Finding``s under those rule names. A
line where the tool says it does not support what a kernel uses (TMA,
``wgmma``, clusters, the async proxy) is kept as a note, not a finding,
and so is a tool that cannot run on the machine at all.
"""
from __future__ import annotations

import dataclasses
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from ..kernels import _build
from . import cases as C
from . import proofs as P

TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
RULE_OF_TOOL = {"memcheck": P.RULE_OOB, "racecheck": P.RULE_RACE,
                "synccheck": P.RULE_DMA_WAIT, "initcheck": P.RULE_ACC_INIT}
TIMEOUT_S = 600.0
# Each family's kernels (their __global__ names in csrc/).
KERNELS = {
    "incrs_spmm": ("expand_kernel", "reuse_kernel", "pipelined_kernel"),
    "incrs_gather": ("gather_kernel", "tile_kernel"),
    "index_match": ("match_kernel", "ring_kernel", "merge_kernel",
                    "merge_ring_kernel", "count_kernel", "scan_kernel",
                    "write_kernel"),
    "dense_mm": ("dense_kernel", "gemm_f32_kernel", "gemm_bf16_kernel"),
    "bsr_spmm": ("bsr_kernel", "gemm_f32_kernel", "gemm_bf16_kernel"),
    "flash_attention": ("flash_kernel_f32", "flash_kernel_bf16"),
}
# What the tools say of a feature they do not model (a note, not a fault).
_UNSUPPORTED = re.compile(
    r"(not supported|unsupported|is not modeled|cannot be checked|"
    r"does not support)", re.I)
_FEATURE = re.compile(r"(TMA|tensor map|wgmma|cluster|async proxy|"
                      r"cp\.async\.bulk|mbarrier|distributed shared)", re.I)
_ERROR = re.compile(r"^=+ (Invalid |Race reported|Barrier error|"
                    r"Uninitialized|Program hit|Error:|Misaligned|"
                    r"Out-of-range|Warp|Malformed|Illegal)", re.I)
_SUMMARY = re.compile(r"(ERROR SUMMARY|RACECHECK SUMMARY): (\d+)")
_NO_DEVICE = re.compile(r"Error: Device not supported[^\n]*")


@dataclasses.dataclass
class ToolRun:
    """One family under one tool: findings, notes, the child's exit code
    and the report's error count."""
    family: str
    tool: str
    findings: List[P.Finding]
    notes: List[str]
    rc: Optional[int]
    errors: Optional[int]
    seconds: float = 0.0


def find_sanitizer() -> Optional[str]:
    """``compute-sanitizer`` of the CUDA toolkit that builds the kernels,
    or on the PATH; None where there is none."""
    cand = [shutil.which("compute-sanitizer"),
            "/usr/local/cuda/bin/compute-sanitizer"]
    try:
        cand.insert(0, os.path.join(os.path.dirname(_build._nvcc()),
                                    "compute-sanitizer"))
    except RuntimeError:
        pass
    return next((c for c in cand if c and os.access(c, os.X_OK)), None)


def kernel_regex(family: str) -> str:
    return "|".join(KERNELS[family])


def parse(family: str, tool: str, text: str) -> Tuple[List[P.Finding],
                                                      List[str],
                                                      Optional[int]]:
    """(findings, notes, the summary's error count) of a report. A tool
    that does not run on the device gives one note and no findings (what
    it reports after that is its own failure)."""
    findings, notes = [], []
    errors = None
    m = _NO_DEVICE.search(text)
    if m:
        return [], [f"{tool} cannot run here: {m.group(0).strip()}"], None
    for ln in text.splitlines():
        m = _SUMMARY.search(ln)
        if m:
            errors = (errors or 0) + int(m.group(2))
            continue
        if _UNSUPPORTED.search(ln):
            feature = _FEATURE.search(ln)
            notes.append(f"{tool} does not model "
                         f"{feature.group(1) if feature else 'a feature'}: "
                         f"{ln.strip('= ').strip()[:200]}")
            continue
        if _ERROR.search(ln):
            findings.append(P.Finding(
                f"{family}/{tool}", RULE_OF_TOOL[tool],
                f"{tool}: {ln.strip('= ').strip()[:200]}",
                f"src/repro_torch/kernels/csrc/{family}.cu", 0))
    return findings, notes, errors


def run_tool(exe: str, family: str, tool: str, *, seed: int = 0,
             timeout: float = TIMEOUT_S, env=None) -> ToolRun:
    """One family's cases, one launch each, under ``tool``."""
    cmd = [exe, "--tool", tool, "--kernel-regex",
           f"kns={kernel_regex(family)}", "--error-exitcode", "17",
           sys.executable, "-m", "repro_torch.analysis.proofs", "--family",
           family, "--seed", str(seed), "--device", "cuda", "--once"]
    if tool == "racecheck":
        cmd[3:3] = ["--racecheck-report", "all"]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, env=env)
        if proc.returncode and "kernel-regex" in proc.stderr:
            # a version without the filter: instrument every kernel
            i = cmd.index("--kernel-regex")
            del cmd[i:i + 2]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=timeout, env=env)
    except subprocess.TimeoutExpired as err:
        text = (err.stdout or b"").decode() if isinstance(err.stdout, bytes) \
            else (err.stdout or "")
        f, notes, errors = parse(family, tool, text)
        notes.append(f"{tool} did not finish within {timeout:.0f} s")
        return ToolRun(family, tool, f, notes, None, errors,
                       time.perf_counter() - t0)
    text = proc.stdout + "\n" + proc.stderr
    findings, notes, errors = parse(family, tool, text)
    done = text.count('"result"')
    if proc.returncode not in (0, 17) and not findings:
        notes.append(f"{tool} ended with {proc.returncode} after {done} "
                     f"cases: {proc.stderr.strip()[-300:]}")
    return ToolRun(family, tool, findings, notes, proc.returncode, errors,
                   time.perf_counter() - t0)


def by_wrapper(findings: Sequence[P.Finding]) -> List[P.Finding]:
    """A family's sanitizer findings, one for each wrapper of the family
    (the proof matrix's rows; a report names a kernel, not a wrapper)."""
    out = []
    for f in findings:
        family = f.case.split("/")[0]
        for w, src in C.SOURCE.items():
            if src == family:
                out.append(dataclasses.replace(f, case=f"{w}/{f.case}"))
    return out


def run(*, families: Sequence[str] = C.FAMILIES,
        tools: Sequence[str] = TOOLS, seed: int = 0, workers: int = 4,
        timeout: float = TIMEOUT_S) -> Dict[str, object]:
    """Every family under every tool (``workers`` at once); where there
    is no ``compute-sanitizer``, ``{"available": False}``."""
    exe = find_sanitizer()
    if exe is None:
        return {"available": False, "runs": []}
    _build.build_all()
    env = dict(os.environ)
    src = str(_build.CSRC.parents[2])
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    jobs = [(f, t) for f in families for t in tools]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        runs = list(pool.map(lambda ft: run_tool(exe, *ft, seed=seed,
                                                 timeout=timeout, env=env),
                             jobs))
    return {"available": True, "exe": exe, "runs": runs}
