"""The one-card dry run (``repro_torch.launch.specs`` / ``dryrun``) against
JAX's ``repro.launch.specs``, and the two ported examples, on the CPU.

JAX's specs come from ``jax.eval_shape`` (no buffer), the port's from the
meta device (no storage). JAX stacks a group's layers along a leading
axis; leaf ``groups/block{i}_{kind}/...`` of group ``g`` is the port's
``blocks.{g * period + i}....`` (``convert.model_from_jax``'s map).
"""
from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro_torch import configs as tconfigs
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.launch import dryrun, specs


def _dt(x) -> str:
    if isinstance(x, torch.dtype):
        return str(x).replace("torch.", "")
    return np.dtype(x).name


def _unstack(cfg, tree, prefix=""):
    """{port name: (shape, dtype)} of a JAX params-shaped tree."""
    out = {}
    period = len(cfg.block_pattern)
    for key, val in tree.items():
        if key == "groups":
            for bname, blk in val.items():
                i = int(bname[len("block"):].split("_")[0])
                for name, leaf in _flat(blk).items():
                    for g in range(cfg.n_groups):
                        out[f"{prefix}blocks.{g * period + i}.{name}"] = (
                            tuple(leaf.shape[1:]), _dt(leaf.dtype))
        elif isinstance(val, dict):
            out.update({f"{prefix}{key}.{k}": v for k, v in
                        _unstack(cfg, val).items()})
        else:
            out[f"{prefix}{key}"] = (tuple(val.shape), _dt(val.dtype))
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _port(tree):
    return {k: (tuple(t.shape), _dt(t.dtype)) for k, t in tree.items()}


def _bytes(leaves):
    return sum(int(np.prod(s)) * np.dtype(jax.numpy.dtype(d)).itemsize
               for s, d in leaves.values())


def _all_meta(tree):
    if isinstance(tree, torch.Tensor):
        return tree.device.type == "meta"
    if isinstance(tree, dict):
        return all(_all_meta(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_all_meta(v) for v in tree)
    return True


ARCHS = tconfigs.ARCH_NAMES


def test_the_archs_are_jax_archs():
    assert ARCHS == jconfigs.ARCH_NAMES


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_opt_specs_match_jax(arch):
    """Every parameter and AdamW leaf (at ``default_opt``) of the full
    config: the same shape, dtype and total bytes as JAX's specs, and
    nothing allocated."""
    cfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
    params = specs.params_specs(cfg)
    jparams, _ = jspecs.params_specs(jcfg)
    want = _unstack(jcfg, jparams)
    assert _port(params) == want
    assert specs.tree_bytes(params) == _bytes(want)
    opt_cfg = specs.default_opt(cfg)
    assert opt_cfg.quantize == jspecs.default_opt(jcfg).quantize
    assert specs.default_n_micro(cfg) == jspecs.default_n_micro(jcfg)
    opt = specs.opt_specs(opt_cfg, params)
    jopt = jspecs.opt_specs(jspecs.default_opt(jcfg), jparams)
    for moment in ("m", "v"):
        got = _port(_flat(opt[moment]))
        assert got == _unstack(jcfg, jopt[moment])
    assert (tuple(opt["count"].shape), _dt(opt["count"].dtype)) == \
        (tuple(jopt["count"].shape), _dt(jopt["count"].dtype))
    jbytes = sum(_bytes(_unstack(jcfg, jopt[m])) for m in ("m", "v")) + \
        int(np.prod(jopt["count"].shape)) * 4
    assert specs.tree_bytes(opt) == jbytes
    assert _all_meta(params) and _all_meta(opt)


@pytest.mark.parametrize("arch,shape", [
    (a, s) for a in ARCHS for s in ("decode_32k", "long_500k")
    if applicable(tconfigs.get(a), SHAPES[s])[0]])
def test_cache_specs_match_jax(arch, shape):
    """The decode cache of a decode cell: per layer the same tensors as
    JAX's stacked cache (the position ``end`` is a host int in the port,
    an int32 array in JAX, and is left out of both)."""
    cfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
    sh = SHAPES[shape]
    cache = specs.cache_specs(cfg, sh.global_batch, sh.seq_len)
    jcache, _ = jspecs.cache_specs(jcfg, sh.global_batch, sh.seq_len)
    got = {f"blocks.{i}.{k}": (tuple(t.shape), _dt(t.dtype))
           for i, c in enumerate(cache) for k, t in c.items()
           if isinstance(t, torch.Tensor)}
    want = {k: v for k, v in _unstack(jcfg, {"groups": jcache}).items()
            if not k.endswith(".end")}
    assert got == want
    assert specs.tree_bytes(cache) == _bytes(want)
    assert _all_meta(cache)


def test_batch_specs_match_jax():
    for arch in ("granite-34b", "internvl2-1b"):
        cfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
        got = specs.batch_specs(cfg, SHAPES["train_4k"])
        want = jspecs.batch_specs(jcfg, SHAPES["train_4k"])
        assert _port(got) == {k: (tuple(v.shape), _dt(v.dtype))
                              for k, v in want.items()}
        assert _all_meta(got)


def test_dryrun_all_writes_one_row_per_applicable_cell(tmp_path, capsys):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--all", "--device", "cpu", "--json",
                        str(out)]) == 0
    rows = json.loads(out.read_text())["cells"]
    want = [(a, s) for a in ARCHS for s in SHAPES
            if applicable(tconfigs.get(a), SHAPES[s])[0]]
    assert [(r["arch"], r["shape"]) for r in rows] == want
    assert len(capsys.readouterr().out.splitlines()) == len(want)
    for r in rows:
        assert r["card_bytes"] == dryrun.CARD_BYTES_STATED
        assert r["total_bytes"] == sum(
            r[f"{k}_bytes"] or 0 for k in ("params", "grads", "opt",
                                          "cache", "acts"))
        assert r["fits"] == (r["total_bytes"] <= r["card_bytes"])
        assert 0 <= r["max_layers"] <= r["n_layers"]
        assert (r["max_layers"] == r["n_layers"]) == r["fits"]
        assert (r["acts_bytes"] is None) == (r["kind"] != "train")
        # the linear model of depth is exact at full depth
        groups = r["n_layers"] // len(tconfigs.get(r["arch"]).block_pattern)
        assert r["fixed_bytes"] + groups * r["bytes_per_group"] == \
            r["total_bytes"]


@pytest.mark.parametrize("arch,shape", [
    ("granite-34b", "train_4k"), ("recurrentgemma-2b", "train_4k"),
    ("mixtral-8x7b", "decode_32k"), ("internvl2-1b", "train_4k")])
def test_dryrun_depth_model_is_exact(arch, shape):
    """The row's bytes, taken from one and two groups, equal a
    measurement of the full-depth config itself."""
    cfg = tconfigs.get(arch)
    row = dryrun.run_cell(arch, shape, device="cpu")
    direct = dryrun._terms(cfg, SHAPES[shape], cfg)
    assert {k: row[f"{k}_bytes"] for k in direct} == direct


def test_dryrun_train_cell_counts_remat_saves():
    """A train cell's activations: the saved tensors of one microbatch's
    forward plus the products "dots" keeps; with remat "nothing" the
    products are gone, so the measure is smaller."""
    import dataclasses
    cfg = dataclasses.replace(tconfigs.get("granite-34b"), n_layers=2)
    dots = dryrun.saved_bytes(cfg, 2, 256)
    none = dryrun.saved_bytes(
        dataclasses.replace(cfg, remat_policy="nothing"), 2, 256)
    assert cfg.remat_policy == "dots" and dots > none > 0
    assert dots - none >= 2 * 2 * 256 * cfg.d_ff * 2   # an FFN product


def test_dryrun_refusals():
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "granite-34b", "--device", "cpu"])
    with pytest.raises(ValueError, match="not a cell"):
        dryrun.run_cell("granite-34b", "long_500k", device="cpu")


def test_quickstart_example_on_the_cpu(capsys):
    from repro_torch.examples import quickstart
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "quickstart OK" in out and "[cpu] spmm(crs, crs)" in out


def test_lm_serve_example_on_the_cpu(capsys):
    from repro_torch.examples import lm_serve
    assert lm_serve.main(["--device", "cpu", "--requests", "3",
                          "--max-new", "4"]) == 0
    assert "3 requests, 12 new tokens" in capsys.readouterr().out
