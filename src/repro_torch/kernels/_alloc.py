"""Where a wrapper allocates the memory its kernel writes: ``empty``.

Every wrapper takes its kernel's output (and the GEMM core's split-K
workspace) from ``empty``, which is ``torch.empty`` unless a caller has
installed an allocator with ``outputs``. The kernel proofs
(``analysis.proofs``) install one that hands out prefilled views with guard
bands on both sides, so that a launch that writes past its output, leaves
an element unwritten or reads its output before it writes it shows in the
bits it leaves there.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional, Sequence

import torch

Allocator = Callable[[Sequence[int], torch.dtype, torch.device],
                     torch.Tensor]

_ALLOCATOR: Optional[Allocator] = None


def empty(shape: Sequence[int], dtype: torch.dtype,
          device) -> torch.Tensor:
    """``torch.empty(shape, dtype, device)``, or the installed allocator's
    tensor of that shape, type and device."""
    if _ALLOCATOR is None:
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    return _ALLOCATOR(tuple(shape), dtype, torch.device(device))


@contextlib.contextmanager
def outputs(allocator: Allocator) -> Iterator[None]:
    """Install ``allocator`` for the wrappers' outputs in this block (one
    at a time: the proofs run one launch at a time)."""
    global _ALLOCATOR
    if _ALLOCATOR is not None:
        raise RuntimeError("an output allocator is installed already")
    _ALLOCATOR = allocator
    try:
        yield
    finally:
        _ALLOCATOR = None
