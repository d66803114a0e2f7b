"""ZeRO / FSDP sharding presets.

The port of ``repro.train.zero``. Everything is a RULE-TABLE override
(``models/sharding.py``): parameters and optimizer states carry logical
axes; these presets decide which logical axes also map onto the "data"
mesh axis.

  * ``FSDP_OVERRIDES``  -- weight matrices shard their d_model ("embed")
    dim over "data" on top of the tensor-parallel "model" dim (2-D weight
    sharding). Optimizer states inherit it: ZeRO-3-like. The sharded
    forward all-gathers such a weight over "data" before use, and autograd
    reduce-scatters its gradient back (``models.spmd``).
  * ``zero1_axes``      -- parameters stay TP-only; only the optimizer
    moments reshard over "data" (classic ZeRO-1): each data shard updates
    its slice and the parameters are all-gathered afterwards
    (``train.trainer``).

``sharding.resolve``'s dedup keeps activations safe: their "embed" dim
stays replicated because "data" is already used by "batch".
"""
from __future__ import annotations

from typing import Dict

from ..models import sharding as sh

FSDP_OVERRIDES: Dict[str, sh.MeshAxes] = {
    "embed": "data",
    # vocab stays on "model"; heads and mlp stay on "model".
}


def zero1_axes(param_axes, rules=None):
    """Optimizer-moment logical axes under ZeRO-1: in each leaf, the first
    logical axis that resolves to nothing gains "fsdp" (= data) sharding,
    unless the leaf already uses "data". ``rules`` defaults to the active
    table (``sharding.axis_rules``)."""
    rules = sh.current_rules() if rules is None else rules

    def one(ax):
        used = set()
        for a in ax:
            used.update(sh.axes_of(rules.get(a) if a else None))
        out, done = [], False
        for a in ax:
            m = rules.get(a) if a else None
            if not done and m is None and "data" not in used:
                out.append("fsdp")       # -> "data" under default rules
                done = True
            else:
                out.append(a)
        return tuple(out)
    return sh.map_axes(one, param_axes)


__all__ = ["FSDP_OVERRIDES", "zero1_axes"]
