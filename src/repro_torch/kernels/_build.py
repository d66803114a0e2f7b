"""Build the CUDA sources in ``csrc/`` at first use and load them by ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into ``build/repro_torch_kernels/`` at the root
of the checkout (listed in ``.gitignore``). The library's file name carries
a hash of its source and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. ``build_all`` starts one ``nvcc`` per
source, all together. A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# Libraries a source links beyond the CUDA runtime: libcuda, for the TMA
# tensor maps that these sources encode on the host.
LINK = {name: ("-lcuda",) for name in ("bsr_spmm", "dense_mm",
                                       "flash_attention", "incrs_spmm")}
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + LINK.get(name, ())


def _headers(source: Path) -> list:
    """The ``csrc/`` headers that ``source`` includes with quotes, and the
    headers they include, each once."""
    found, todo = [], [source]
    while todo:
        for inc in _INCLUDE.findall(todo.pop().read_bytes()):
            path = CSRC / inc.decode()
            if path not in found and path.is_file():
                found.append(path)
                todo.append(path)
    return sorted(found)


def lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current
    source, the headers it includes, and its flags."""
    source = CSRC / f"{name}.cu"
    h = hashlib.sha256(source.read_bytes())
    for header in _headers(source):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output (ptxas registers, shared memory, spills) of
    the last build of ``name``, or "" if it was never built here."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named source (default: all of ``csrc/``) that has no
    library for its current hash: one ``nvcc`` each, started together."""
    names = list(sources() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        lib = lib_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = lib.with_suffix(".log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu"), *LINK.get(name, ())],
                stdout=fh, stderr=subprocess.STDOUT)
        running.append((name, proc, tmp, lib, log))
    failed = []
    for name, proc, tmp, lib, log in running:
        if proc.wait() != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n"
                          f"{log.read_text()[-4000:]}")
            continue
        os.replace(tmp, lib)        # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: lib_path(name) for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib
