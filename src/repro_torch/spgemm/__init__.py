"""Sparse × sparse (SpGEMM): the condense/merge round-stripe pipeline.

The port of ``repro.spgemm``. ``kernels`` holds the two kernels' wrappers
(condense -> per-round partial stripes, merge -> round-ordered sum),
``pipeline`` the two-pass runner, the output-density estimator and the
standalone ``spgemm`` entry. ``ops.spmm(CRS, CRS | InCRS)`` reaches the
same runner with ``variant="condense_merge"``.
"""
from .kernels import spgemm_condense, spgemm_merge
from .pipeline import (SPARSE_OUTPUT_THRESHOLD, condense_merge_prepped,
                       estimate_output_density, spgemm)

__all__ = [
    "spgemm_condense",
    "spgemm_merge",
    "condense_merge_prepped",
    "estimate_output_density",
    "spgemm",
    "SPARSE_OUTPUT_THRESHOLD",
]
