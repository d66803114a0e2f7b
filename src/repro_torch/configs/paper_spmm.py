"""The paper's own workload configs: SpMM on the Table II / IV datasets."""
from __future__ import annotations

import dataclasses

from ..data.datasets import TABLE2_DATASETS, TABLE4_DATASETS, DatasetSpec


@dataclasses.dataclass(frozen=True)
class SpmmWorkload:
    name: str
    dataset: DatasetSpec
    mesh_n: int = 64              # N_synch (Table V)
    rounds: int = 32              # R
    section: int = 256            # S (InCRS)
    block: int = 32               # b (InCRS)


WORKLOADS = {
    **{f"incrs-{k}": SpmmWorkload(f"incrs-{k}", v)
       for k, v in TABLE2_DATASETS.items()},
    **{f"mesh-{k}": SpmmWorkload(f"mesh-{k}", v)
       for k, v in TABLE4_DATASETS.items()},
}

DEFAULT = WORKLOADS["incrs-docword"]
