"""Abstract stand-ins for the dry run: every model input, parameter,
optimizer state and decode cache as a tensor on ``torch.device("meta")``.

The port of ``repro.launch.specs``. JAX builds ``ShapeDtypeStruct`` trees
with ``jax.eval_shape``; here the same constructors run on the meta
device, which records shapes and dtypes and allocates nothing. The trees
are the port's own: parameters by ``named_parameters()`` name (one leaf a
layer where JAX stacks a group's layers), the AdamW state of
``train.optimizer.adamw_init``, the per-layer decode caches of
``models.model.init_cache``. Their logical axes are
``models.model.init_axes`` and ``init_cache_axes``, and the mesh dry run
(``launch.dryrun.mesh_bytes``) places them by the rule table.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..configs.shapes import ShapeSpec
from ..models import layers
from ..models import model as M
from ..models.config import ModelConfig
from ..train.optimizer import AdamWConfig, adamw_init

META = torch.device("meta")


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Training-batch stand-ins: {tokens, labels [, prefix_embeds]}."""
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": torch.empty((b, s), dtype=torch.int32, device=META),
           "labels": torch.empty((b, s), dtype=torch.int32, device=META)}
    if cfg.input_mode == "embeds":
        out["prefix_embeds"] = torch.empty(
            (b, cfg.n_prefix_embeds, cfg.d_model),
            dtype=layers.torch_dtype(cfg.dtype), device=META)
    return out


def meta_model(cfg: ModelConfig, *, dtype: Optional[str] = None
               ) -> M.Model:
    """The model of ``cfg`` on the meta device (``dtype`` overrides the
    parameter dtype)."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=dtype)
    return M.Model(cfg, device=META)


def params_specs(cfg: ModelConfig, *, dtype: Optional[str] = None
                 ) -> Dict[str, torch.Tensor]:
    """{name: meta tensor} of every parameter (``dtype`` overrides the
    parameter dtype)."""
    return dict(meta_model(cfg, dtype=dtype).named_parameters())


def opt_specs(opt_cfg: AdamWConfig, params: Dict[str, torch.Tensor]
              ) -> Dict[str, Any]:
    """The AdamW state ``adamw_init`` builds for ``params``, on meta."""
    return adamw_init(opt_cfg, params)


def cache_specs(cfg: ModelConfig, batch: int, alloc_seq: int,
                dtype=torch.bfloat16) -> list:
    """One decode cache a layer, on meta (each keeps its position as a
    host int, ``"end"``, where JAX keeps an int32 array)."""
    return M.init_cache(cfg, batch, alloc_seq, dtype, device=META)


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of a dict / list tree."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


# ----------------------------------------------------------------------
def default_n_micro(cfg: ModelConfig) -> int:
    """Microbatches of train_4k, JAX's rule: 16 above 300 B parameters,
    else 8 (it sized a v5e chip's activations; kept so both packages cut
    one cell the same way)."""
    return 16 if cfg.param_count() > 300e9 else 8


def default_opt(cfg: ModelConfig) -> AdamWConfig:
    """int8 moments for the >= 100 B configs, f32 otherwise."""
    return AdamWConfig(quantize=cfg.param_count() > 100e9)
