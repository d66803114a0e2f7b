"""Workload configs: the paper's SpMM workloads (``paper_spmm``) and the
architecture registry, ``get(name)`` -> full config, ``get_smoke(name)``.

The registry holds the architectures whose every module is ported:
attention, the dense MLP or the MoE FFN, token or embeds input. The other
names of the JAX registry raise ``NotImplementedError`` naming the
ROADMAP item that ports what they need.
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict

from ..models.config import ModelConfig
from . import (granite_34b, internvl2_1b, llama3_405b, mistral_large_123b,
               mixtral_8x7b, musicgen_medium, phi3_medium_14b,
               qwen2_moe_a27b)

_MODULES: Dict[str, ModuleType] = {
    "granite-34b": granite_34b,
    "phi3-medium-14b": phi3_medium_14b,
    "mistral-large-123b": mistral_large_123b,
    "llama3-405b": llama3_405b,
    "mixtral-8x7b": mixtral_8x7b,
    "qwen2-moe-a2.7b": qwen2_moe_a27b,
    "musicgen-medium": musicgen_medium,
    "internvl2-1b": internvl2_1b,
}

# What each architecture of the JAX registry still needs (ROADMAP queue 1
# item 12b).
UNPORTED: Dict[str, str] = {
    "mamba2-370m": "the SSD mixer (layers.ssd)",
    "recurrentgemma-2b": "the RG-LRU mixer (layers.rglru)",
}

ARCH_NAMES = tuple(_MODULES)


def _module(name: str) -> ModuleType:
    if name in UNPORTED:
        raise NotImplementedError(
            f"{name} needs {UNPORTED[name]}, not ported yet (ROADMAP queue 1 "
            f"item 12b)")
    return _MODULES[name]


def get(name: str) -> ModelConfig:
    return _module(name).FULL


def get_smoke(name: str) -> ModelConfig:
    return _module(name).smoke()
