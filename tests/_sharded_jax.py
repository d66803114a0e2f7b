"""The sharded MoE FFN, SSD and RG-LRU mixers and block-sparse FFN against
the JAX package's one-device model on the CPU, on the same weights and
inputs: the cases and the two checks that the
``tests/test_torch_lm_sharded_jax_*.py`` files run.

JAX's smoke configs of mixtral-8x7b, qwen2-moe-a2.7b (under the default
rules and under the EP rule ``{"experts": "model"}``), mamba2-370m,
recurrentgemma-2b, and granite-34b with a block-sparse FFN (blocks of 16,
half of them zeroed), in f32; and under JAX's serve and train overrides
(``launch.dryrun.cell_overrides`` of the full config: a context-parallel
KV cache, ``cache_seq``, for every serve; sequence-parallel attention,
``attn_q_seq``, where 16 does not divide the heads) phi3-medium-14b,
internvl2-1b (with its prefix embeddings; its train cell's override too)
and recurrentgemma-2b, and granite-34b's step under ZeRO-1 without FSDP,
whose block moments are owned by layer. JAX's weights (the recurrent
mixers' leaves redrawn by ``draw_mixer_leaf``, so that the state carries
the output) go to the port by ``convert.model_from_jax`` and onto a CPU
mesh by ``spmd.shard_model``.

Train: three AdamW steps of the port's sharded step (``build_train_step``
inside ``sharding.axis_rules``, FSDP and ZeRO-1 on unless the case says,
a (data 2, model 4) mesh) against JAX's jitted ``make_step_fn`` on one
device, at the bounds
``tests/test_torch_lm_train.py`` holds the one-device port to: the loss
rtol 1e-5, the clipping norm rtol 1e-4, every parameter within 1e-4 of
its max|p|. Serve: a prefill of 20 positions then 6 decode steps (4
under the overrides, so that the cache's 24 slots, or 40 after 16 prefix
embeddings, split over "model") on the mesh each family is hardest on,
against JAX's ``prefill_step`` and ``decode_step``: logits rtol = atol =
1e-4 (``tests/test_torch_lm.py``'s bound).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp
from _recurrent_draw import MIXER_LEAVES, draw_mixer_leaf
from _sharded_lm import mesh

from repro import configs as jconfigs
from repro.data.pipeline import SyntheticTokens
from repro.models import config as jconfig
from repro.models import model as jmodel
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch.dryrun import cell_overrides
from repro_torch.models import config as tconfig
from repro_torch.models import model as tmodel
from repro_torch.models import sharding as tsh
from repro_torch.models import spmd
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer
from repro_torch.train.zero import FSDP_OVERRIDES

STEP_TOL = 1e-4
LOGIT_TOL = 1e-4
EP = {"experts": "model"}
# case: (architecture, block-sparse FFN, rules, serve mesh)
CASES = {
    "mixtral": ("mixtral-8x7b", False, None, (2, 4)),
    "qwen2": ("qwen2-moe-a2.7b", False, None, (2, 2, 2)),
    "qwen2_ep": ("qwen2-moe-a2.7b", False, EP, (2, 4)),
    "mamba2": ("mamba2-370m", False, None, (1, 8)),  # conv shards cut heads
    "recurrentgemma": ("recurrentgemma-2b", False, None, (2, 4)),
    "granite_sparse": ("granite-34b", True, None, (2, 4)),
}
# JAX's overrides of the full config's cells: serve under the prefill
# cell's, train (rules given in full, FSDP not added) under the train
# cell's; "granite_zero1": ZeRO-1 alone, layers owning their moments
OVERRIDES = ("phi3-medium-14b", "internvl2-1b", "recurrentgemma-2b")
for _arch in OVERRIDES:
    CASES[f"{_arch.split('-')[0]}_overrides"] = (
        _arch, False, cell_overrides(tconfigs.get(_arch), "prefill"),
        (2, 4))
TRAIN_RULES = {
    "internvl2_train": ("internvl2-1b",
                        cell_overrides(tconfigs.get("internvl2-1b"),
                                       "train")),
    "granite_zero1": ("granite-34b", {}),
}
CASES.update({k: (a, False, r, (2, 4)) for k, (a, r) in
              TRAIN_RULES.items()})


def _pair(case):
    """(JAX cfg, JAX params, port model) on the same weights."""
    name, sparse, _, _ = CASES[case]
    jcfg, tcfg = jconfigs.get_smoke(name), tconfigs.get_smoke(name)
    if sparse:
        jcfg = dataclasses.replace(jcfg,
                                   sparsity=jconfig.BlockSparsity(block=16))
        tcfg = dataclasses.replace(tcfg,
                                   sparsity=tconfig.BlockSparsity(block=16))
    params, _ = jmodel.init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(9)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.asarray(draw_mixer_leaf(path[-1].key, v.shape,
                                                    rng), v.dtype)
        if path[-1].key in MIXER_LEAVES else v, params)
    if sparse:
        rng = np.random.default_rng(6)
        for blk in params["groups"].values():
            ffn = blk["ffn"]
            for k in [k for k in ffn if k.startswith("mask_")]:
                ffn[k] = jnp.asarray(rng.random(ffn[k].shape) < 0.5,
                                     jnp.float32)
    model = convert.model_from_jax(tcfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    return jcfg, params, model


def _by_name(cfg, tree):
    """JAX's params as {port parameter name: array}, masks left out."""
    out = {"embed": tree["embed"], "norm_final": tree["norm_final"]}
    if not cfg.tie_embeddings:
        out["unembed"] = tree["unembed"]
    period = len(cfg.block_pattern)
    for i, kind in enumerate(cfg.block_pattern):
        blk = tree["groups"][f"block{i}_{kind}"]
        for g in range(cfg.n_groups):
            pre = f"blocks.{g * period + i}."
            for name, leaf in blk.items():
                if isinstance(leaf, dict):
                    for sub, arr in leaf.items():
                        if not sub.startswith("mask_"):
                            out[f"{pre}{name}.{sub}"] = np.asarray(arr[g])
                else:
                    out[f"{pre}{name}"] = np.asarray(leaf[g])
    return out


def _prefix(cfg, b, seed):
    """Prefix embeddings (B, P, d) of an embeds config, else None."""
    if cfg.input_mode != "embeds":
        return None
    return np.random.default_rng(seed).normal(
        size=(b, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)


def check_step(case):
    jcfg, params, model = _pair(case)
    rules = (dict(TRAIN_RULES[case][1]) if case in TRAIN_RULES else
             dict(FSDP_OVERRIDES, **(CASES[case][2] or {})))
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    data = SyntheticTokens(jcfg.vocab_size, 4, 24, seed=3)
    batches = [data.batch_at(i) for i in range(3)]
    for i, b in enumerate(batches):
        pfx = _prefix(jcfg, 4, 10 + i)
        if pfx is not None:
            b["prefix_embeds"] = pfx
    jstep = jax.jit(jtrainer.make_step_fn(jcfg, jopt.AdamWConfig(**opt)))
    jp, jst, jm = params, jopt.adamw_init(jopt.AdamWConfig(**opt), params), []
    for b in batches:
        jp, jst, m = jstep(jp, jst, {k: jnp.asarray(v) for k, v in b.items()})
        jm.append(m)
    mh = mesh((2, 4))
    sm = spmd.shard_model(model, mh, rules)
    with tsh.axis_rules(mh, rules):
        step = ttrainer.build_train_step(model.cfg, topt.AdamWConfig(**opt))
        state = ttrainer.init_sharded_opt_state(topt.AdamWConfig(**opt), sm)
        for b, m in zip(batches, jm):
            sm, state, tm = step(sm, state, b)
            np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]),
                                       rtol=1e-5)
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(m["grad_norm"]), rtol=1e-4)
    want = _by_name(jcfg, jp)
    assert set(want) == set(sm.params)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(sm.params[k].full().numpy(), w, rtol=0,
                                   atol=STEP_TOL * scale, err_msg=k)
    assert int(state["count"]) == 3
    assert sm.mesh.collectives["all-reduce"]["count"] > 0


def check_serve(case):
    jcfg, params, model = _pair(case)
    _, _, rules, shape = CASES[case]
    sm = spmd.shard_model(model, mesh(shape), rules)
    rng = np.random.default_rng(4)
    prompt, steps = 20, (4 if rules and "cache_seq" in rules else 6)
    toks = rng.integers(0, jcfg.vocab_size, (4, prompt)).astype(np.int32)
    feed = rng.integers(0, jcfg.vocab_size, (steps, 4, 1)).astype(np.int32)
    pfx = _prefix(jcfg, 4, 11)
    npfx = 0 if pfx is None else pfx.shape[1]
    prompt += npfx
    alloc = prompt + steps
    jl, jc = jmodel.prefill_step(
        jcfg, params, jnp.asarray(toks), alloc_seq=alloc,
        prefix_embeds=None if pfx is None else jnp.asarray(pfx),
        cache_dtype=jnp.float32)
    tl, tc = tmodel.prefill_step(
        sm, torch.from_numpy(toks), alloc_seq=alloc,
        prefix_embeds=None if pfx is None else torch.from_numpy(pfx),
        cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.full().numpy(), np.asarray(jl),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for t in range(steps):
        jl, jc = jmodel.decode_step(jcfg, params, jnp.asarray(feed[t]), jc,
                                    pos=prompt + t)
        tl, tc = tmodel.decode_step(sm, torch.from_numpy(feed[t]), tc,
                                    pos=prompt + t)
        np.testing.assert_allclose(tl.full().numpy(), np.asarray(jl),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=f"decode step {t}")
    assert tc[0]["end"] == prompt + steps
    return tc
