"""Sparse layers and plans behind one front door (``incrs``, ``bsr``,
``dense`` and the plan–execute ``crs``; ``incrs`` also row-sharded over a
``launch.mesh.Mesh``).

``SparseSpec`` (what the operand looks like), ``plan``/``MatmulPlan``
(prep once, execute many), ``BoundPlan`` (a plan over values: the serving
operand), ``plan_for_operand`` and ``Linear``/``apply`` (one layer
constructor and one apply), over the pattern module's
``SparsityPattern``, selections and lifecycle (``repack``,
``magnitude_repack``, ``repack_onto``, ``PruneSchedule``).
"""
from .api import (FORMATS, BoundPlan, CRSPlanMeta,  # noqa: F401
                  DenseLinearMeta, DenseLinearParams, FormatAdapter,
                  Linear, MatmulPlan,
                  SparseSpec, adapter_of, apply, plan, plan_for_operand,
                  register_format, stack_init)
from .linear import (InCRSLinearMeta, InCRSLinearParams,  # noqa: F401
                     ShardedInCRSLinearMeta, ShardedInCRSLinearParams,
                     SparseLinearMeta, SparseLinearParams,
                     incrs_sharded_to_dense_weight, incrs_to_dense_weight,
                     real_blocks, to_dense)
from .pattern import (FamilyOps, PruneSchedule,  # noqa: F401
                      SparsityPattern, expand_block_mask, get_pattern,
                      is_lifecycle_node, is_stacked_node, magnitude_mask,
                      magnitude_repack, nm_mask, node_to_dense, parse_nm,
                      repack, repack_onto)
from .prune import prune_to_bsr, sparsity_schedule  # noqa: F401
