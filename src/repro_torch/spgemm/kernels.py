"""Condense/merge SpGEMM kernels: sparse × sparse through round stripes.

The port of ``repro.spgemm.kernels``. The fused ``index_match_spmm`` adds
each round's partial product into an accumulator; SpGEMM splits that into
two passes:

  condense  S[t, i, j] = the round-t partial p(i, j, t), every (i, j, t)
            independent, into an f32 (n_rounds, M, N) stripe array;
  merge     C = sum of S[t] over t ascending, f32, one cast at the end.

Both reach the CUDA kernels written by hand for Hopper in
``kernels/csrc/index_match.cu``. Condense runs in the instance that
``index_match_spmm.match_geometry`` picks (the ring, its (tile, round)
items spread over the CTAs, or the general kernel) and computes p with
the same device function as the fused kernel of that instance, and merge
adds the rounds in the fused kernel's order, so condense + merge equals
``index_match_spmm`` bit for bit on identically prepped operands, the JAX
contract. The plain versions keep
the same property on the CPU: plain condense stores the plain per-round
partials, and plain merge adds them as the plain fused version does.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises. ``LAUNCHES`` counts each kernel's launches.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..kernels import index_match_spmm as _im

LAUNCHES: Dict[str, int] = {"spgemm_condense": 0, "spgemm_merge": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_stripes(stripes: torch.Tensor, bm: int, bn: int) -> None:
    if stripes.ndim != 3:
        raise ValueError(f"stripes must be (n_rounds, M, N), got "
                         f"{tuple(stripes.shape)}")
    _, m, n = stripes.shape
    if m % bm or n % bn:
        raise ValueError(f"stripe shape {(m, n)} must align to tiles "
                         f"{(bm, bn)}")


def plain_condense(a_idx: torch.Tensor, a_val: torch.Tensor,
                   b_idx: torch.Tensor, b_val: torch.Tensor, *,
                   rounds: int = 128, bm: int = 128,
                   bn: int = 128) -> torch.Tensor:
    """The plain torch version of ``spgemm_condense`` on any device."""
    m, n, n_rounds = _im.check_operands("spgemm_condense", a_idx, a_val,
                                        b_idx, b_val, bm, bn)
    out = torch.empty((n_rounds, m, n), dtype=torch.float32,
                      device=a_idx.device)
    for t in range(n_rounds):
        out[t] = _im.round_partial(a_idx, a_val, b_idx, b_val, t, rounds)
    return out


def plain_merge(stripes: torch.Tensor, *, bm: int = 128, bn: int = 128,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain torch version of ``spgemm_merge`` on any device."""
    _check_stripes(stripes, bm, bn)
    acc = torch.zeros(stripes.shape[1:], dtype=torch.float32,
                      device=stripes.device)
    for t in range(stripes.shape[0]):
        acc = acc + stripes[t]
    return acc.to(out_dtype)


def spgemm_condense(a_idx: torch.Tensor, a_val: torch.Tensor,
                    b_idx: torch.Tensor, b_val: torch.Tensor, *,
                    rounds: int = 128, bm: int = 128, bn: int = 128,
                    geometry: Optional[_im.MatchGeometry] = None
                    ) -> torch.Tensor:
    """Partial stripes S[n_rounds, M, N] f32: S[t] = A_t @ B_t.T per round.

    Summing over the first axis in ascending order (``spgemm_merge``)
    gives C = A @ B.T. The array is indexed with 64-bit offsets: it may
    exceed 2**31 elements. ``geometry`` overrides
    ``index_match_spmm.match_geometry`` on the card (sweeps).
    """
    if a_idx.device.type == "cpu":
        return plain_condense(a_idx, a_val, b_idx, b_val, rounds=rounds,
                              bm=bm, bn=bn)
    m, n, n_rounds = _im.check_operands("spgemm_condense", a_idx, a_val,
                                        b_idx, b_val, bm, bn)
    if a_idx.device.type != "cuda":
        raise ValueError(f"spgemm_condense: no kernel for device "
                         f"{a_idx.device}")
    out = torch.empty((n_rounds, m, n), dtype=torch.float32,
                      device=a_idx.device)
    if _im.launch_match("spgemm_condense", a_idx, a_val, b_idx, b_val, out,
                        rounds, geometry):
        LAUNCHES["spgemm_condense"] += 1
    return out


def spgemm_merge(stripes: torch.Tensor, *, bm: int = 128, bn: int = 128,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C[M, N] = sum_t S[t] in ascending round order, f32, with the one
    cast to ``out_dtype`` at the end."""
    if stripes.device.type == "cpu":
        return plain_merge(stripes, bm=bm, bn=bn, out_dtype=out_dtype)
    _check_stripes(stripes, bm, bn)
    if stripes.device.type != "cuda":
        raise ValueError(f"spgemm_merge: no kernel for device "
                         f"{stripes.device}")
    if stripes.dtype != torch.float32:
        raise TypeError(f"spgemm_merge: stripes must be float32, got "
                        f"{stripes.dtype}")
    if not stripes.is_contiguous():
        raise ValueError("spgemm_merge: stripes must be contiguous")
    n_rounds, m, n = stripes.shape
    out = torch.empty((m, n), dtype=torch.float32, device=stripes.device)
    if out.numel() == 0:
        return out.to(out_dtype)
    lib = _im.library()
    stream = torch.cuda.current_stream(stripes.device).cuda_stream
    err = lib.spgemm_merge(stripes.data_ptr(), out.data_ptr(), m * n,
                           n_rounds, stripes.device.index, stream)
    _im.raise_on_error(lib, "spgemm_merge", err)
    LAUNCHES["spgemm_merge"] += 1
    return out.to(out_dtype)
