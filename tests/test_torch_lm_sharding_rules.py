"""The port's rule table, ZeRO presets and AdamW-state axes against the JAX
package's, and the mesh dry run's per-device bytes against JAX's shard
shapes, for the ten full configs on JAX's 16 x 16 and 2 x 16 x 16 meshes.

JAX's ``axis_rules`` and ``resolve`` read only a mesh's ``axis_names`` and
the shape of its ``devices`` array, so a stand-in with those two gives
JAX's specs with no device. JAX's trees come from ``jax.eval_shape`` (no
buffer) and stack a group's layers along a leading axis; leaf
``groups/block{i}_{kind}/...`` of group ``g`` is the port's
``blocks.{g * period + i}....``, and its spec's leading ``"layers"`` entry
has no counterpart in the port's per-layer spec, except for the moments,
where the port keeps JAX's stacked spec (``trainer.moment_specs_of``).
Every comparison is exact.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import os
import types

import jax
import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401
import torch

from repro import configs as jconfigs
from repro.configs.shapes import SHAPES as JSHAPES
from repro.models import model as jmodel
from repro.models import sharding as jsh
from repro.train import optimizer as jopt
from repro.train import zero as jzero
from repro_torch import configs as tconfigs
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.launch import dryrun, mesh as tmesh, specs
from repro_torch.models import model as tmodel
from repro_torch.models import sharding as tsh
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer
from repro_torch.train import zero as tzero

_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun                # noqa: E402
if _flags is None:          # importing it sets a 512-device flag
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = tconfigs.ARCH_NAMES


def _jmesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, dtype=object))


def _sizes(name):
    shape, axes = MESHES[name]
    return dict(zip(axes, shape))


@functools.lru_cache(maxsize=None)
def _jax_trees(arch):
    cfg = jconfigs.get(arch)
    params = jax.eval_shape(lambda k: jmodel.init(cfg, k)[0],
                            jax.random.PRNGKey(0))
    return cfg, params, jmodel.init_axes(cfg)


@functools.lru_cache(maxsize=None)
def _jax_opt(arch, quantize):
    _, params, _ = _jax_trees(arch)
    opt = jopt.AdamWConfig(quantize=quantize)
    return jax.eval_shape(lambda p: jopt.adamw_init(opt, p), params)


@functools.lru_cache(maxsize=None)
def _jax_cache(arch, batch, seq):
    cfg = jconfigs.get(arch)
    return jax.eval_shape(lambda: jmodel.init_cache(
        cfg, batch, seq, jax.numpy.dtype(cfg.dtype))[0])


def _node(v) -> bool:
    """A dict to walk into (an int8 moment's {"q", "s"} is a leaf)."""
    return isinstance(v, dict) and set(v) != {"q", "s"}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if _node(v):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _port_names(cfg, tree, stacked=False):
    """{port name: leaf} of a JAX params-shaped tree; a stacked leaf's
    spec loses its leading entry unless ``stacked``."""
    out = {}
    period = len(cfg.block_pattern)
    for key, val in tree.items():
        if key != "groups":
            if _node(val):
                out.update({f"{key}.{k}": v for k, v in _flat(val).items()})
            else:
                out[key] = val
            continue
        for bname, blk in val.items():
            i = int(bname[len("block"):].split("_")[0])
            for name, leaf in _flat(blk).items():
                for g in range(cfg.n_groups):
                    out[f"blocks.{g * period + i}.{name}"] = (
                        leaf if stacked else _drop(leaf))
    return out


def _drop(leaf):
    if isinstance(leaf, dict):
        return {k: tuple(v)[1:] for k, v in leaf.items()}
    return tuple(leaf)[1:]


def _tup(spec):
    return tuple(spec)


def _p(spec):
    """A port spec as JAX's ``PartitionSpec`` holds it (this JAX stores a
    one-axis tuple entry as the axis name): the comparison is JAX's own
    equality of specs."""
    if isinstance(spec, dict):
        return {k: _p(v) for k, v in spec.items()}
    return tuple(jsh.P(*spec))


def _jspecs(name, overrides, axes, tree):
    with jsh.axis_rules(_jmesh(name), overrides):
        return jax.tree.map(_tup, jsh.spec_tree(axes, tree),
                            is_leaf=lambda x: isinstance(x, jsh.P))


def _rule_sets(jcfg):
    serve = jdryrun.serve_rules(jcfg)
    return {"default": {}, "fsdp": dict(jzero.FSDP_OVERRIDES),
            "serve": serve,
            "train_cell": {**jdryrun.default_overrides(jcfg, "train"),
                           **jzero.FSDP_OVERRIDES},
            "prefill_cell": {**jdryrun.default_overrides(jcfg, "prefill"),
                             **serve},
            "decode_cell": {**jdryrun.default_overrides(jcfg, "decode"),
                            **serve}}


def test_default_rules_are_jax_rules():
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES
    assert tsh.INCRS_STRIPE_AXES == jsh.INCRS_STRIPE_AXES
    assert tzero.FSDP_OVERRIDES == jzero.FSDP_OVERRIDES


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_overrides_are_jax_dryruns(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    for kind in ("train", "prefill", "decode"):
        want = jdryrun.default_overrides(jcfg, kind)
        want.update(jzero.FSDP_OVERRIDES if kind == "train"
                    else jdryrun.serve_rules(jcfg))
        assert dryrun.cell_overrides(tcfg, kind) == want
    assert dryrun.serve_rules(tcfg) == jdryrun.serve_rules(jcfg)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_cache_and_opt_specs_match_jax(arch, mesh_name):
    """Every parameter's spec, every decode-cache spec, and both moments'
    specs (f32 with and without ZeRO-1, int8 ``{"q", "s"}``) under the
    default rules, FSDP, the serve rules and JAX's three cell overrides."""
    jcfg, params, jaxes = _jax_trees(arch)
    tcfg = tconfigs.get(arch)
    taxes = tmodel.init_axes(tcfg)
    tshapes = {k: tuple(p.shape) for k, p in
               specs.params_specs(tcfg).items()}
    assert set(taxes) == set(tshapes) == set(_port_names(jcfg, jaxes))
    sizes = _sizes(mesh_name)
    jmesh = _jmesh(mesh_name)
    tm = tmesh.Mesh(np.full(MESHES[mesh_name][0], "meta", dtype=object),
                    MESHES[mesh_name][1])
    cache_sds = _jax_cache(arch, 128, 4096)
    tcache = specs.cache_specs(tcfg, 128, 4096)
    for label, ov in _rule_sets(jcfg).items():
        rules = tsh.filter_rules(tm, ov)
        want = _port_names(jcfg, _jspecs(mesh_name, ov, jaxes, params))
        got = {k: _p(tsh.resolve_with(rules, sizes, taxes[k], tshapes[k]))
               for k in taxes}
        assert got == want, label
        # the decode cache, layer by layer
        jc = _jspecs(mesh_name, ov, jmodel.init_cache_axes(jcfg), cache_sds)
        for li, cax in enumerate(tmodel.init_cache_axes(tcfg)):
            i = li % len(jcfg.block_pattern)
            blk = jc[f"block{i}_{jcfg.block_pattern[i]}"]
            for k, ax in cax.items():
                assert _p(tsh.resolve_with(rules, sizes, ax, tuple(
                    tcache[li][k].shape))) == blk[k][1:], (label, li, k)
        # AdamW state: f32 with and without ZeRO-1, int8
        for opt, zero1 in ((jopt.AdamWConfig(), True),
                           (jopt.AdamWConfig(), False),
                           (jopt.AdamWConfig(quantize=True), True)):
            osds = _jax_opt(arch, opt.quantize)
            with jsh.axis_rules(jmesh, ov):
                oax = jopt.opt_state_axes(opt, jaxes)
                if zero1 and not opt.quantize:
                    oax = {"m": jzero.zero1_axes(oax["m"]),
                           "v": jzero.zero1_axes(oax["v"]), "count": ()}
            jm = _jspecs(mesh_name, ov, oax["m"], osds["m"])
            want_m = _port_names(jcfg, jm, stacked=True)
            topt_cfg = topt.AdamWConfig(quantize=opt.quantize)
            got_m = ttrainer.moment_specs_of(topt_cfg, taxes, tshapes, rules,
                                             sizes, zero1=zero1,
                                             n_groups=tcfg.n_groups)
            want_m = {k: ({q: _tup(v[q]) for q in v} if isinstance(v, dict)
                          else _tup(v)) for k, v in want_m.items()}
            assert {k: _p(v) for k, v in got_m.items()} == want_m, (
                label, opt.quantize, zero1)
            assert ttrainer.per_layer(got_m) == {
                k: _drop(v) if k.startswith("blocks.") else v
                for k, v in got_m.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_trees_match_jax(arch):
    """``init_axes``, ``init_cache_axes``, ``opt_state_axes`` and
    ``zero1_axes`` leaf for leaf (JAX's leading "layers" dropped), the
    last inside JAX's and the port's default-rule context."""
    jcfg, _, jaxes = _jax_trees(arch)
    tcfg = tconfigs.get(arch)
    taxes = tmodel.init_axes(tcfg)
    assert taxes == _port_names(jcfg, jaxes)
    jcache = jmodel.init_cache_axes(jcfg)
    for li, cax in enumerate(tmodel.init_cache_axes(tcfg)):
        i = li % len(jcfg.block_pattern)
        jb = jcache[f"block{i}_{jcfg.block_pattern[i]}"]
        assert cax == {k: v[1:] for k, v in jb.items() if k != "end"}
    for q in (False, True):
        jo = jopt.opt_state_axes(jopt.AdamWConfig(quantize=q), jaxes)
        to = topt.opt_state_axes(topt.AdamWConfig(quantize=q), taxes)
        assert to["count"] == jo["count"] == ()
        want = _port_names(jcfg, jo["m"], stacked=True)
        assert to["m"] == to["v"] == {
            k: _drop(v) if k.startswith("blocks.") else v
            for k, v in want.items()}
    mesh = _jmesh("16x16")
    tm = tmesh.make_production_mesh(device="meta")
    for ov in ({}, dict(jzero.FSDP_OVERRIDES)):
        with jsh.axis_rules(mesh, ov):
            jz = jzero.zero1_axes(jaxes)
        with tsh.axis_rules(tm, ov):
            tz = tzero.zero1_axes(taxes)
        top = {k: v for k, v in _port_names(jcfg, jz).items()
               if not k.startswith("blocks.")}
        assert {k: tz[k] for k in top} == top
        # a block parameter's "fsdp" lands on JAX's "layers" or nowhere
        stacked = _port_names(jcfg, jz, stacked=True)
        with tsh.axis_rules(tm, ov):
            for k in taxes:
                if k.startswith("blocks."):
                    assert tzero.zero1_axes(
                        {k: ("layers",) + taxes[k]})[k] == stacked[k]


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_bytes_match_jax_shard_shapes(arch, mesh_name):
    """The mesh dry run's per-device parameter and AdamW bytes in the train
    cell are JAX's spec_tree shard shapes summed over ``jax.eval_shape``
    of JAX's params and state; its cache bytes in the decode cell, JAX's
    over its cache."""
    jcfg, params, jaxes = _jax_trees(arch)
    tcfg = tconfigs.get(arch)
    sizes = _sizes(mesh_name)
    tm = tmesh.Mesh(np.full(MESHES[mesh_name][0], "meta", dtype=object),
                    MESHES[mesh_name][1])

    def shard_bytes(spec_tree, sds_tree):
        total = 0
        for sp, sd in zip(jax.tree.leaves(spec_tree, is_leaf=lambda x:
                                          isinstance(x, tuple)),
                          jax.tree.leaves(sds_tree)):
            n = 1
            for dim, e in zip(sd.shape, sp):
                div = 1
                for a in tsh.axes_of(e):
                    div *= sizes[a]
                n *= dim // div
            total += n * np.dtype(sd.dtype).itemsize
        return total

    ov = dryrun.cell_overrides(tcfg, "train")
    got = dryrun.mesh_bytes(tcfg, SHAPES["train_4k"], sizes,
                            tsh.filter_rules(tm, ov))
    assert got["params"] == shard_bytes(_jspecs(mesh_name, ov, jaxes,
                                                params), params)
    opt = jopt.AdamWConfig(quantize=specs.default_opt(tcfg).quantize)
    osds = _jax_opt(arch, opt.quantize)
    with jsh.axis_rules(_jmesh(mesh_name), ov):
        oax = jopt.opt_state_axes(opt, jaxes)
        if not opt.quantize:
            oax = {"m": jzero.zero1_axes(oax["m"]),
                   "v": jzero.zero1_axes(oax["v"]), "count": ()}
    want = sum(shard_bytes(_jspecs(mesh_name, ov, oax[k], osds[k]), osds[k])
               for k in ("m", "v")) + 4
    assert got["opt"] == want
    shape = SHAPES["decode_32k"]
    ov = dryrun.cell_overrides(tcfg, "decode")
    got = dryrun.mesh_bytes(tcfg, shape, sizes, tsh.filter_rules(tm, ov))
    csds = _jax_cache(arch, shape.global_batch, shape.seq_len)
    cspec = _jspecs(mesh_name, ov, jmodel.init_cache_axes(jcfg), csds)
    drop_end = lambda t: {b: {k: v for k, v in d.items() if k != "end"}
                          for b, d in t.items()}
    assert got["cache"] == shard_bytes(drop_end(cspec), drop_end(csds))


def test_resolve_never_overshards():
    """JAX's property test on the port: every sharded dim divides and no
    mesh axis is used twice, against JAX's resolve on the same input."""
    tm = tmesh.Mesh(np.full((2, 4, 8), "meta", dtype=object),
                    ("pod", "data", "model"))
    jm = types.SimpleNamespace(axis_names=("pod", "data", "model"),
                               devices=np.empty((2, 4, 8), dtype=object))
    with tsh.axis_rules(tm), jsh.axis_rules(jm):
        for logical in itertools.permutations(
                ["batch", "vocab", "mlp", "embed", "qblocks"], 3):
            for shape in [(1, 1, 1), (2, 3, 5), (16, 32, 64), (8, 24, 40)]:
                spec = tsh.resolve(logical, shape)
                assert _p(spec) == tuple(jsh.resolve(logical, shape))
                used = [a for e in spec for a in tsh.axes_of(e)]
                assert len(used) == len(set(used))
                for dim, e in zip(shape, spec):
                    n = int(np.prod([tm.shape[a] for a in tsh.axes_of(e)]))
                    assert dim % n == 0


def test_shard_slice_and_spec_tree():
    sizes = {"pod": 2, "data": 4, "model": 8}
    # ("pod", "data"): pod outermost
    got = [tsh.shard_slice(16, ("pod", "data"), sizes,
                           {"pod": p, "data": d, "model": 0})
           for p in range(2) for d in range(4)]
    assert got == [slice(2 * i, 2 * i + 2) for i in range(8)]
    assert tsh.shard_slice(5, None, sizes, {}) == slice(0, 5)
    with pytest.raises(ValueError, match="does not split"):
        tsh.shard_slice(6, "model", sizes, {"model": 0})
    assert tsh.shard_shape((16, 64, 3), (("pod", "data"), "model", None),
                           sizes) == (2, 8, 3)
    tm = tmesh.Mesh(np.full((4, 8), "meta", dtype=object), ("data", "model"))
    with tsh.axis_rules(tm, {"embed": "data"}):
        tree = {"a": ("embed", "mlp"), "b": {"c": ("vocab",)}}
        shapes = {"a": torch.empty(8, 16), "b": {"c": torch.empty(12)}}
        assert tsh.spec_tree(tree, shapes) == {"a": ("data", "model"),
                                               "b": {"c": (None,)}}
        assert tsh.spec_tree(tree) == {"a": ("data", "model"),
                                       "b": {"c": ("model",)}}


def test_production_and_pipeline_meshes():
    one = tmesh.make_production_mesh(device="meta")
    assert one.shape == {"data": 16, "model": 16} and one.size == 256
    two = tmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert two.axis_names == ("pod", "data", "model")
    assert two.devices.shape == (2, 16, 16)
    assert two.coords()[17] == {"pod": 0, "data": 1, "model": 1}
    pipe = tmesh.make_pipeline_mesh(4, "cpu")
    assert pipe.shape == {"pipe": 4, "data": 1}
    assert tmesh.make_pipeline_mesh(2, "meta").device_list[1].type == "meta"
    if not torch.cuda.is_available():
        for make in (tmesh.make_production_mesh, tmesh.make_pipeline_mesh):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()


@pytest.mark.parametrize("arch", ["granite-34b", "mixtral-8x7b"])
def test_mesh_dryrun_rows(arch, capsys):
    """The CLI on the 16 x 16 mesh: a row a cell with its overrides and
    bytes and its collectives, the MoE family's too."""
    import json
    out = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                       f"mesh-dryrun-{os.getpid()}-{arch}.json")
    try:
        assert dryrun.main(["--arch", arch, "--shape", "decode_32k",
                            "--single-pod", "--device", "cpu",
                            "--json", out]) == 0
        with open(out) as fh:
            rows = json.load(fh)["cells"]
    finally:
        if os.path.exists(out):
            os.remove(out)
    (row,) = rows
    assert row["mesh"] == "16x16" and row["n_devices"] == 256
    tcfg = tconfigs.get(arch)
    assert row["overrides"] == dryrun.cell_overrides(tcfg, "decode")
    assert row["total_bytes"] == sum(row[f"{k}_bytes"] for k in
                                     ("params", "grads", "opt", "cache"))
    assert "unexecuted_rules" not in row and \
        row["overrides"]["cache_seq"] == "model"
    assert row["collectives"]["all-reduce"]["count"] > 0
    assert row["wire_bytes_per_device"] > 0
    assert "16x16" in capsys.readouterr().out
    assert applicable(tcfg, SHAPES["decode_32k"])[0]
    assert JSHAPES["decode_32k"].seq_len == SHAPES["decode_32k"].seq_len
    assert dataclasses.asdict(JSHAPES["train_4k"]) == dataclasses.asdict(
        SHAPES["train_4k"])
