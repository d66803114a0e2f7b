"""Workload configs: the paper's SpMM workloads (``paper_spmm``) and the
architecture registry, ``get(name)`` -> full config, ``get_smoke(name)``.

The registry holds the ten architectures of the JAX registry, in its order:
attention, the dense MLP or the MoE FFN, token or embeds input, and the
SSD (mamba2-370m) and RG-LRU (recurrentgemma-2b) mixers. ``SHAPES`` and
``applicable`` are the four assigned input shapes and their rule.
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict

from ..models.config import ModelConfig
from . import (granite_34b, internvl2_1b, llama3_405b, mamba2_370m,
               mistral_large_123b, mixtral_8x7b, musicgen_medium,
               phi3_medium_14b, qwen2_moe_a27b, recurrentgemma_2b)
from .shapes import SHAPES, ShapeSpec, applicable  # noqa: F401

_MODULES: Dict[str, ModuleType] = {
    "musicgen-medium": musicgen_medium,
    "mamba2-370m": mamba2_370m,
    "mixtral-8x7b": mixtral_8x7b,
    "qwen2-moe-a2.7b": qwen2_moe_a27b,
    "internvl2-1b": internvl2_1b,
    "granite-34b": granite_34b,
    "phi3-medium-14b": phi3_medium_14b,
    "mistral-large-123b": mistral_large_123b,
    "llama3-405b": llama3_405b,
    "recurrentgemma-2b": recurrentgemma_2b,
}

ARCH_NAMES = tuple(_MODULES)


def get(name: str) -> ModelConfig:
    return _MODULES[name].FULL


def get_smoke(name: str) -> ModelConfig:
    return _MODULES[name].smoke()
