"""Assigned input-shape sets (the 4 LM shapes; 10 archs x 4 = 40 cells)."""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs; decode
    shapes only for archs with a decode step (all ours are decoders)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full quadratic attention: 500k decode skipped per "
                       "assignment (sub-quadratic archs only)")
    return True, ""
