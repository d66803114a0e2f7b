"""Counter-located section stripes -> dense rows: the InCRS gather.

The port of ``repro.kernels.incrs_gather``. ``incrs_gather`` keeps the
Pallas contract (same arguments, ``M % bm == 0``, f32 output of shape
(M, n_sections * section)) and reaches the CUDA kernel written by hand for
Hopper in ``csrc/incrs_gather.cu``. The stripes come from
``ops.prep_sections``, located through the packed counter words alone.

A tensor on the CPU takes the plain torch version (a scatter-add onto
zeros); a CUDA tensor launches the kernel or raises. The two agree bit for
bit. ``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build
from .ref import incrs_decompress

LAUNCHES: Dict[str, int] = {"incrs_gather": 0}


def reset_launches() -> None:
    LAUNCHES["incrs_gather"] = 0


def _library() -> ctypes.CDLL:
    lib = _build.library("incrs_gather")
    if not getattr(lib, "_repro_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.incrs_gather.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.incrs_gather.restype = i
        lib.incrs_gather_error_string.argtypes = [i]
        lib.incrs_gather_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _check(idx: torch.Tensor, val: torch.Tensor, bm: int) -> None:
    if idx.ndim != 3 or idx.shape != val.shape:
        raise ValueError(f"incrs_gather: idx and val must be one (M, "
                         f"n_sections, smax) shape, got {tuple(idx.shape)} "
                         f"and {tuple(val.shape)}")
    if idx.device != val.device:
        raise ValueError(f"incrs_gather: idx and val must share one device, "
                         f"got {idx.device} and {val.device}")
    if idx.shape[0] % bm != 0:
        raise ValueError(f"m={idx.shape[0]} must be a multiple of bm={bm}")


def _launch(idx: torch.Tensor, val: torch.Tensor,
            section: int) -> torch.Tensor:
    """Validate, allocate the dense output, launch on the current stream
    and count the launch. Raises on anything the kernel does not take."""
    if idx.dtype != torch.int32 or val.dtype != torch.float32:
        raise TypeError(f"incrs_gather: stripes must be int32/float32, got "
                        f"{idx.dtype}/{val.dtype}")
    if not (idx.is_contiguous() and val.is_contiguous()):
        raise ValueError("incrs_gather: idx and val must be contiguous")
    m, n_sections, smax = idx.shape
    if n_sections * smax >= 2 ** 31:
        raise ValueError(f"incrs_gather: {n_sections} x {smax} slots per row "
                         f"overflow the kernel's int32 slot index")
    out = torch.empty((m, n_sections * section), dtype=torch.float32,
                      device=idx.device)
    if out.numel() == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    err = lib.incrs_gather(idx.data_ptr(), val.data_ptr(), out.data_ptr(), m,
                           n_sections, smax, section, idx.device.index,
                           stream)
    if err:
        raise RuntimeError(f"incrs_gather: CUDA error {err} at launch: "
                           f"{lib.incrs_gather_error_string(err).decode()}")
    LAUNCHES["incrs_gather"] += 1
    return out


def plain(idx: torch.Tensor, val: torch.Tensor, *, section: int = 256,
          bm: int = 8) -> torch.Tensor:
    """The plain torch version on any device, with the wrapper's checks:
    what the kernel is held against."""
    _check(idx, val, bm)
    n_cols = idx.shape[1] * section
    return incrs_decompress(idx, val, n_cols, section)


def incrs_gather(idx: torch.Tensor, val: torch.Tensor, *, section: int = 256,
                 bm: int = 8) -> torch.Tensor:
    """Dense[M, n_sections * section] f32 from padded per-section rows.

    idx : (M, n_sections, smax) int32 local column within section, -1 = pad
    val : (M, n_sections, smax) float32
    """
    if idx.device.type == "cpu":
        return plain(idx, val, section=section, bm=bm)
    _check(idx, val, bm)
    if idx.device.type != "cuda":
        raise ValueError(f"incrs_gather: no kernel for device {idx.device}")
    return _launch(idx, val, section)
