"""Round-synchronized index-matching SpMM: the paper's Alg. 2, C = A @ B.T.

The port of ``repro.kernels.index_match_spmm``. Both operands are sparse
rows in the per-round padded form of ``ops.prep_rounds``:

  idx (rows, n_rounds, rmax) int32 local index in [0, R), -1 = padding
  val (rows, n_rounds, rmax) values

``index_match_spmm`` keeps the Pallas contract (same arguments, row counts
multiples of ``bm``/``bn``, f32 accumulation over rounds ascending and one
cast at the end to ``out_dtype``, by default the operands' promoted type)
and reaches the CUDA kernel written by hand for Hopper in
``csrc/index_match.cu``. That source also holds the condense and merge
kernels of ``repro_torch.spgemm``, which share its per-round partial and
therefore equal it bit for bit; ``library`` binds all three.

A tensor on the CPU takes the plain torch version (each round's windows
densified and multiplied, f32, rounds added ascending); a CUDA tensor
launches the kernel or raises. ``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import _build
from .incrs_spmm import SMEM_LIMIT
from .ref import round_densify

LAUNCHES: Dict[str, int] = {"index_match_spmm": 0}

# CUDA grid rows of 64 output rows each: gridDim.y is at most 65535.
_MAX_ROWS = 64 * 65535


def reset_launches() -> None:
    LAUNCHES["index_match_spmm"] = 0


def library() -> ctypes.CDLL:
    """``csrc/index_match.cu`` built and bound: index_match_spmm,
    spgemm_condense and spgemm_merge."""
    lib = _build.library("index_match")
    if not getattr(lib, "_repro_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.index_match_spmm, lib.spgemm_condense):
            fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
            fn.restype = i
        lib.spgemm_merge.argtypes = [p, p, ctypes.c_longlong, i, i, p]
        lib.spgemm_merge.restype = i
        lib.index_match_smem_bytes.argtypes = [i]
        lib.index_match_smem_bytes.restype = ctypes.c_size_t
        lib.index_match_error_string.argtypes = [i]
        lib.index_match_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def raise_on_error(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch: "
                           f"{lib.index_match_error_string(err).decode()}")


def check_operands(name: str, a_idx: torch.Tensor, a_val: torch.Tensor,
                   b_idx: torch.Tensor, b_val: torch.Tensor, bm: int,
                   bn: int) -> Tuple[int, int, int]:
    """The Pallas wrappers' checks: one device, idx/val pairs of one 3-D
    shape, equal round counts, rows aligned to the tiles. Returns
    ``(M, N, n_rounds)``."""
    if len({a_idx.device, a_val.device, b_idx.device, b_val.device}) != 1:
        raise ValueError(f"{name}: the four operand arrays must share one "
                         f"device")
    for idx, val, side in ((a_idx, a_val, "A"), (b_idx, b_val, "B")):
        if idx.ndim != 3 or idx.shape != val.shape:
            raise ValueError(f"{name}: {side} idx and val must be one (rows, "
                             f"n_rounds, rmax) shape, got {tuple(idx.shape)} "
                             f"and {tuple(val.shape)}")
    m, n_rounds, _ = a_idx.shape
    n, n_rounds_b, _ = b_idx.shape
    if n_rounds != n_rounds_b:
        raise ValueError(
            f"operand round counts differ: {n_rounds} vs {n_rounds_b}")
    if m % bm or n % bn:
        raise ValueError(f"shape {(m, n)} must align to tiles {(bm, bn)} "
                         f"(ops.index_match_prepped pads)")
    return m, n, n_rounds


def round_partial(a_idx: torch.Tensor, a_val: torch.Tensor,
                  b_idx: torch.Tensor, b_val: torch.Tensor, t: int,
                  rounds: int) -> torch.Tensor:
    """Plain f32 partial of round ``t``: A's and B's round-t windows
    densified to (rows, R) and multiplied, A_t @ B_t.T."""
    da = round_densify(a_idx[:, t:t + 1], a_val[:, t:t + 1], rounds, rounds)
    db = round_densify(b_idx[:, t:t + 1], b_val[:, t:t + 1], rounds, rounds)
    return da @ db.T


def launch_match(name: str, a_idx: torch.Tensor, a_val: torch.Tensor,
                 b_idx: torch.Tensor, b_val: torch.Tensor, out: torch.Tensor,
                 rounds: int) -> bool:
    """Validate and launch ``index_match_spmm`` (``out`` is C, (M, N)) or
    ``spgemm_condense`` (``out`` is S, (n_rounds, M, N)) on the current
    stream. Values are taken as f32 (exact for f16/bf16). Raises on
    anything the kernel does not take and on a CUDA error at launch.
    Returns whether it launched (an empty ``out`` needs no launch)."""
    if a_idx.dtype != torch.int32 or b_idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32, got {a_idx.dtype}/"
                        f"{b_idx.dtype}")
    if not (a_val.is_floating_point() and b_val.is_floating_point()):
        raise TypeError(f"{name}: values must be floating point, got "
                        f"{a_val.dtype}/{b_val.dtype}")
    a_val = a_val.to(torch.float32)
    b_val = b_val.to(torch.float32)
    for t, what in ((a_idx, "A idx"), (a_val, "A val"), (b_idx, "B idx"),
                    (b_val, "B val")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    m, n_rounds, rmax_a = a_idx.shape
    n, _, rmax_b = b_idx.shape
    if not 1 <= rounds < 2 ** 31 or m > _MAX_ROWS or n >= 2 ** 31:
        raise ValueError(f"{name}: rounds={rounds}, M={m}, N={n} outside "
                         f"the kernel's grid (M <= {_MAX_ROWS})")
    lib = library()
    smem = lib.index_match_smem_bytes(rounds)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: a dense round window of R={rounds} needs "
                         f"{smem} bytes of shared memory per block, over the "
                         f"card's {SMEM_LIMIT}")
    if out.numel() == 0:
        return False
    stream = torch.cuda.current_stream(a_idx.device).cuda_stream
    err = getattr(lib, name)(
        a_idx.data_ptr(), a_val.data_ptr(), b_idx.data_ptr(),
        b_val.data_ptr(), out.data_ptr(), m, n, n_rounds, rmax_a, rmax_b,
        rounds, a_idx.device.index, stream)
    raise_on_error(lib, name, err)
    return True


def _resolve_out_dtype(a_val: torch.Tensor, b_val: torch.Tensor,
                       out_dtype: Optional[torch.dtype]) -> torch.dtype:
    if out_dtype is None:
        return torch.promote_types(a_val.dtype, b_val.dtype)
    return out_dtype


def plain(a_idx: torch.Tensor, a_val: torch.Tensor, b_idx: torch.Tensor,
          b_val: torch.Tensor, *, rounds: int = 128, bm: int = 128,
          bn: int = 128, out_dtype: Optional[torch.dtype] = None
          ) -> torch.Tensor:
    """The plain torch version on any device, with the wrapper's checks:
    what the kernel is held against."""
    out_dtype = _resolve_out_dtype(a_val, b_val, out_dtype)
    m, n, n_rounds = check_operands("index_match_spmm", a_idx, a_val, b_idx,
                                    b_val, bm, bn)
    acc = torch.zeros((m, n), dtype=torch.float32, device=a_idx.device)
    for t in range(n_rounds):
        acc = acc + round_partial(a_idx, a_val, b_idx, b_val, t, rounds)
    return acc.to(out_dtype)


def index_match_spmm(a_idx: torch.Tensor, a_val: torch.Tensor,
                     b_idx: torch.Tensor, b_val: torch.Tensor, *,
                     rounds: int = 128, bm: int = 128, bn: int = 128,
                     out_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """C[M, N] = A[M, K] @ B[N, K].T from per-round padded sparse rows.

    Accumulation is f32 over rounds ascending; the one cast to
    ``out_dtype`` (default: the promoted type of the two value arrays)
    happens at the end.
    """
    if a_idx.device.type == "cpu":
        return plain(a_idx, a_val, b_idx, b_val, rounds=rounds, bm=bm,
                     bn=bn, out_dtype=out_dtype)
    out_dtype = _resolve_out_dtype(a_val, b_val, out_dtype)
    m, n, _ = check_operands("index_match_spmm", a_idx, a_val, b_idx, b_val,
                             bm, bn)
    if a_idx.device.type != "cuda":
        raise ValueError(f"index_match_spmm: no kernel for device "
                         f"{a_idx.device}")
    out = torch.empty((m, n), dtype=torch.float32, device=a_idx.device)
    if launch_match("index_match_spmm", a_idx, a_val, b_idx, b_val, out,
                    rounds):
        LAUNCHES["index_match_spmm"] += 1
    return out.to(out_dtype)
