"""Sparse layers and plans behind one front door (``incrs``, ``bsr`` and
``dense``).

``SparseSpec`` (what the operand looks like), ``plan``/``MatmulPlan``
(prep once, execute many), ``BoundPlan`` (a plan over values: the serving
operand), ``plan_for_operand`` and ``Linear``/``apply`` (one layer
constructor and one apply), over the pattern module's
``SparsityPattern`` and selections.
"""
from .api import (FORMATS, BoundPlan, DenseLinearMeta,  # noqa: F401
                  DenseLinearParams, FormatAdapter, Linear, MatmulPlan,
                  SparseSpec, adapter_of, apply, plan, plan_for_operand,
                  register_format)
from .linear import (InCRSLinearMeta, InCRSLinearParams,  # noqa: F401
                     SparseLinearMeta, SparseLinearParams,
                     incrs_to_dense_weight, real_blocks, to_dense)
from .pattern import (FamilyOps, SparsityPattern,  # noqa: F401
                      expand_block_mask, get_pattern, magnitude_mask,
                      nm_mask, parse_nm)
