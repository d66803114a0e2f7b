"""Synthetic Table II / IV datasets."""
from .datasets import (TABLE2_DATASETS, TABLE4_DATASETS, DatasetSpec, scaled,
                       synthesize)

__all__ = ["DatasetSpec", "TABLE2_DATASETS", "TABLE4_DATASETS", "scaled",
           "synthesize"]
