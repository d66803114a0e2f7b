"""One table of every rule of the port's analysis gate.

Four families, one namespace: ``launch_check`` (resources a launch needs),
``proofs`` (the kernel proofs on the card: JAX's grid-interpreter and DMA
rule names), ``sanitizer`` (``compute-sanitizer``'s reports, filed under
the proofs' rules) and ``lint``. ``all_rules`` raises on a name that two
families describe differently, so one table cannot shadow another.
"""
from __future__ import annotations

from typing import Dict

from . import launch_check, lint, proofs, sanitizer

FAMILIES = {"lint": lint.RULE_DESCRIPTIONS,
            "launch_check": launch_check.RULES,
            "proofs": proofs.RULES,
            "sanitizer": {r: proofs.RULES[r]
                          for r in sanitizer.RULE_OF_TOOL.values()}}


def all_rules() -> Dict[str, str]:
    """name -> one-line description, every family merged (a collision
    raises)."""
    merged: Dict[str, str] = {}
    for family in FAMILIES.values():
        for name, desc in family.items():
            if name in merged and merged[name] != desc:
                raise ValueError(f"rule name collision: {name!r}")
            merged[name] = desc
    return merged
