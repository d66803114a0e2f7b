"""Synthetic Table II / IV datasets and the LM token pipeline."""
from .datasets import (TABLE2_DATASETS, TABLE4_DATASETS, DatasetSpec, scaled,
                       synthesize)
from .pipeline import Prefetcher, SyntheticTokens

__all__ = ["DatasetSpec", "TABLE2_DATASETS", "TABLE4_DATASETS", "Prefetcher",
           "SyntheticTokens", "scaled", "synthesize"]
