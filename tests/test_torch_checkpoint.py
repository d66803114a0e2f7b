"""The port's checkpoint manager (``repro_torch.checkpoint``): every case
of ``tests/test_checkpoint.py`` on the port (atomicity, retention,
auto-resume, custom nodes, patterns mid-schedule, elastic restore), a
checkpoint written by the JAX manager read by the port's, the LM's
model and AdamW state (f32 and int8 moments), and the reprune example's
checkpoint/resume half. Restored values are compared bitwise."""
import json
import os

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401

torch = pytest.importorskip("torch")

import jax                                                # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa
from repro_torch import configs                           # noqa: E402
from repro_torch.checkpoint import CheckpointManager      # noqa: E402
from repro_torch.launch.mesh import make_mesh             # noqa: E402
from repro_torch.sparse import Linear, SparseSpec         # noqa: E402
from repro_torch.sparse import linear as slin             # noqa: E402
from repro_torch.sparse import pattern as spat            # noqa: E402
from repro_torch.train import optimizer as topt           # noqa: E402
from repro_torch.train import trainer                     # noqa: E402

SPEC = SparseSpec("incrs", density=0.3, section=16, block=4)


def _tree(x=0.0):
    return {"params": {"w": torch.full((4, 4), 1.0 + x),
                       "b": torch.zeros(3)},
            "opt": {"m": [torch.ones(2), torch.zeros(5)],
                    "count": torch.tensor(7, dtype=torch.int32)}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_save_restore_roundtrip(tmp_path):
    ck = CheckpointManager(str(tmp_path), async_write=False)
    t = _tree(0.5)
    ck.save(3, t)
    assert ck.latest_step() == 3
    got = ck.restore(3, _tree())
    for a, b in zip(_leaves(got), _leaves(t)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_async_writer_and_wait(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    for s in range(1, 4):
        ck.save(s, _tree(s))
    ck.wait()
    assert ck.latest_step() == 3
    got = ck.restore(3, _tree())
    assert float(got["params"]["w"][0, 0]) == 4.0


def test_async_save_is_a_snapshot(tmp_path, monkeypatch):
    """``save`` copies every leaf before it returns: a write the writer
    thread has not made yet still holds the values of the moment of the
    save after the caller changes the tensors, arrays and parameters in
    place (as the next train step does)."""
    import threading
    gate = threading.Event()
    savez = np.savez

    def held(*args, **kw):
        gate.wait(timeout=30)
        return savez(*args, **kw)
    monkeypatch.setattr(np, "savez", held)
    lin = torch.nn.Linear(3, 2)
    tree = {"t": torch.arange(6, dtype=torch.float32), "a": np.ones(4),
            "bf": torch.ones(3, dtype=torch.bfloat16), "mod": lin}
    want = {"t": tree["t"].clone(), "a": tree["a"].copy(),
            "bf": tree["bf"].clone(), "w": lin.weight.detach().clone()}
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, tree)
    with torch.no_grad():
        tree["t"].add_(100.0)
        tree["bf"].mul_(3.0)
        lin.weight.add_(1.0)
    tree["a"] += 5.0
    gate.set()
    ck.wait()
    got = ck.restore(1, {"t": torch.zeros(6), "a": np.zeros(4),
                         "bf": torch.zeros(3, dtype=torch.bfloat16),
                         "mod": torch.nn.Linear(3, 2)})
    assert torch.equal(got["t"], want["t"])
    assert np.array_equal(got["a"], want["a"])
    assert torch.equal(got["bf"], want["bf"])
    assert torch.equal(got["mod"].weight.detach(), want["w"])


def test_retention(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2, keep_every=10,
                           async_write=False)
    for s in [5, 10, 15, 20, 25]:
        ck.save(s, _tree(s))
    files = sorted(os.listdir(tmp_path))
    steps = {int(f[5:13]) for f in files if f.startswith("step_")}
    assert steps == {10, 20, 25}          # newest 2 + %10 milestones


def test_partial_write_ignored(tmp_path):
    """A crash mid-write (tmp file left behind) must not corrupt resume."""
    ck = CheckpointManager(str(tmp_path), async_write=False)
    ck.save(1, _tree(1))
    with open(tmp_path / "tmp.99.1234", "wb") as f:
        f.write(b"garbage")
    with open(tmp_path / "step_00000099.npz", "wb") as f:
        f.write(b"also garbage")
    assert ck.latest_step() == 1          # manifest rules
    got = ck.restore(1, _tree())
    assert float(got["params"]["w"][0, 0]) == 2.0


def test_corrupt_manifest_recovers(tmp_path):
    ck = CheckpointManager(str(tmp_path), async_write=False)
    ck.save(1, _tree())
    with open(tmp_path / "manifest.json", "w") as f:
        f.write("{not json")
    assert ck.latest_step() is None       # treated as empty, no crash
    ck.save(2, _tree())
    assert ck.latest_step() == 2


def test_missing_array_and_writer_failure_raise(tmp_path):
    ck = CheckpointManager(str(tmp_path), async_write=False)
    ck.save(1, {"w": torch.ones(2)})
    with pytest.raises(KeyError, match="missing array 'v'"):
        ck.restore(1, {"w": torch.ones(2), "v": torch.ones(2)})
    bad = CheckpointManager(str(tmp_path / "bad"))
    os.rmdir(tmp_path / "bad")            # the writer cannot write
    bad.save(1, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="writer failed"):
        bad.wait()


def test_custom_pytree_node_roundtrip(tmp_path):
    """A sparse params node round-trips by its values; a moment mirror on
    the same meta comes back on the same (restored) meta."""
    ck = CheckpointManager(str(tmp_path), async_write=False)
    p = Linear.init(32, 64, SPEC, generator=_gen(0), device="cpu").inner
    tree = {"params": {"l1": p},
            "m": {"l1": slin.InCRSLinearParams(p.values * 0 + 2.0, p.meta)}}
    ck.save(1, tree)
    tpl = Linear.init(32, 64, SPEC, generator=_gen(0), device="cpu").inner
    got = ck.restore(1, {"params": {"l1": tpl},
                         "m": {"l1": slin.InCRSLinearParams(
                             tpl.values * 0, tpl.meta)}})
    assert torch.equal(got["params"]["l1"].values, p.values)
    assert float(got["m"]["l1"].values[0, 0, 0]) == 2.0
    assert got["m"]["l1"].meta is got["params"]["l1"].meta


def test_pattern_restores_mid_schedule(tmp_path):
    """A repacked (re-pruned) layer restores into a FRESH dense template:
    the saved pattern re-targets the template's shapes and version."""
    spec = SparseSpec("incrs", density=1.0, section=16, block=4)
    ck = CheckpointManager(str(tmp_path), async_write=False)
    p0 = Linear.init(32, 64, spec, generator=_gen(1), device="cpu").inner
    p1 = spat.magnitude_repack(spat.magnitude_repack(p0, 0.5), 0.2)
    assert spat.get_pattern(p1).version == 2
    ck.save(7, {"params": {"l1": p1}})
    tpl = Linear.init(32, 64, spec, generator=_gen(1), device="cpu").inner
    assert tpl.values.shape != p1.values.shape       # really re-shaped
    got = ck.restore(7, {"params": {"l1": tpl}})["params"]["l1"]
    assert spat.get_pattern(got).version == 2
    np.testing.assert_array_equal(spat.get_pattern(got).mask,
                                  spat.get_pattern(p1).mask)
    np.testing.assert_array_equal(slin.incrs_to_dense_weight(got),
                                  slin.incrs_to_dense_weight(p1))


@pytest.mark.parametrize("fmt", ["incrs", "bsr", "dense"])
def test_linear_modules_restore_in_place_mid_schedule(tmp_path, fmt):
    """``sparse.Linear`` modules in a tree (a model): patterns saved, the
    fresh template's layers repacked in place, AdamW moments (keyed by
    parameter name) restored at the saved shapes, and a step from the
    restored state equal to the step from the saved one."""
    spec = {"incrs": SparseSpec("incrs", density=1.0, section=16, block=4),
            "bsr": SparseSpec("bsr", density=1.0, block=8),
            "dense": SparseSpec("dense", density=1.0)}[fmt]

    def student():
        return torch.nn.ModuleDict({
            "l1": Linear.init(32, 48, spec, generator=_gen(3),
                              device="cpu"),
            "l2": Linear.init(48, 16, spec, generator=_gen(4),
                              device="cpu")})
    opt = topt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                           weight_decay=0.0)
    model = student()
    state = topt.adamw_init(opt, dict(model.named_parameters()))
    x = torch.randn(8, 32, generator=_gen(5))
    y = torch.randn(8, 16, generator=_gen(6))

    def step(model, state):
        params = dict(model.named_parameters())
        loss = ((model["l2"](torch.tanh(model["l1"](x))) - y) ** 2).mean()
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        _, state, _ = topt.adamw_update(opt, grads, state, params)
        return state

    state = step(model, state)
    cb = trainer.make_prune_callback(spat.PruneSchedule(0.25, 4,
                                                        warmup_frac=0.0,
                                                        every=1))
    assert cb(2, model, state) is not None
    state = step(model, state)
    ck = CheckpointManager(str(tmp_path), async_write=False)
    ck.save(2, {"params": model, "opt": state})
    fresh = student()
    tpl = {"params": fresh,
           "opt": topt.adamw_init(opt, dict(fresh.named_parameters()))}
    got = ck.restore(2, tpl)
    assert got["params"] is fresh
    for name in ("l1", "l2"):
        assert fresh[name].pattern.version == model[name].pattern.version > 0
        np.testing.assert_array_equal(fresh[name].pattern.mask,
                                      model[name].pattern.mask)
        assert torch.equal(fresh[name].values, model[name].values)
    for k in ("m", "v"):
        for name, t in state[k].items():
            assert torch.equal(got["opt"][k][name], t)
    assert torch.equal(got["opt"]["count"], state["count"])
    s1, s2 = step(model, state), step(fresh, got["opt"])
    for (_, a), (_, b) in zip(model.named_parameters(),
                              fresh.named_parameters()):
        assert torch.equal(a, b)
    assert all(torch.equal(s1["m"][k], s2["m"][k]) for k in s1["m"])


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """The on-disk contract is JAX's: a JAX manager's checkpoint of a
    re-pruned InCRS ``Linear`` and plain arrays restores into a fresh port
    template (same keys, the pattern retargeted, the values bit for
    bit)."""
    from repro.sparse import Linear as JLinear
    from repro.sparse import SparseSpec as JSpec
    from repro.sparse import linear as jlin
    from repro.sparse import pattern as jspat
    jspec = JSpec("incrs", density=1.0, section=16, block=4)
    jl = JLinear.init(jax.random.PRNGKey(2), 32, 64, jspec)
    jl = JLinear(jspat.magnitude_repack(jl.inner, 0.3))
    jck = JCheckpointManager(str(tmp_path), async_write=False)
    jck.save(5, {"params": {"l1": jl, "w": np.arange(6.0, dtype=np.float32)},
                 "count": np.asarray(9, np.int32)})
    ck = CheckpointManager(str(tmp_path), async_write=False)
    assert ck.latest_step() == 5
    spec = SparseSpec("incrs", density=1.0, section=16, block=4)
    lin = Linear.init(32, 64, spec, generator=_gen(0), device="cpu")
    got = ck.restore(5, {"params": {"l1": lin, "w": torch.zeros(6)},
                         "count": torch.tensor(0, dtype=torch.int32)})
    assert lin.pattern.version == 1
    np.testing.assert_array_equal(lin.pattern.mask,
                                  np.asarray(jspat.get_pattern(
                                      jl.inner).mask))
    np.testing.assert_array_equal(lin.to_dense(),
                                  jlin.incrs_to_dense_weight(jl.inner))
    assert torch.equal(got["params"]["w"], torch.arange(6.0))
    assert int(got["count"]) == 9


@pytest.mark.parametrize("quantize", [False, True])
def test_lm_state_roundtrip(tmp_path, quantize):
    """An LM's parameters and AdamW state (f32, or int8 moments with
    their scales) restore bit for bit into a fresh model; bf16 tensors
    keep their dtype."""
    cfg = configs.get_smoke("granite-34b")
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=5,
                           quantize=quantize)
    model, state = trainer.init_train_state(cfg, opt, seed=1, device="cpu")
    batch = {"tokens": np.arange(32).reshape(2, 16) % cfg.vocab_size,
             "labels": (np.arange(32).reshape(2, 16) + 1) % cfg.vocab_size}
    step = trainer.make_step_fn(cfg, opt)
    model, state, _ = step(model, state, batch)
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, {"params": model, "opt": state,
                "extra": torch.linspace(0, 1, 7, dtype=torch.bfloat16)})
    ck.wait()
    fresh, fstate = trainer.init_train_state(cfg, opt, seed=2, device="cpu")
    got = ck.restore(1, {"params": fresh, "opt": fstate,
                         "extra": torch.zeros(7, dtype=torch.bfloat16)},
                     device="cpu")
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              fresh.state_dict().items()):
        assert torch.equal(a, b), k
    for a, b in zip(_leaves(state), _leaves(got["opt"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got["extra"].dtype == torch.bfloat16
    assert torch.equal(got["extra"],
                       torch.linspace(0, 1, 7, dtype=torch.bfloat16))
    _, m1 = step(model, state, batch)[1:]
    _, m2 = step(fresh, got["opt"], batch)[1:]
    assert torch.equal(m1["loss"], m2["loss"])


def test_moe_lm_state_roundtrip(tmp_path):
    """A mixtral smoke model (the MoE FFN's router and 3-D expert tensors)
    and its AdamW state after one step restore bit for bit into a fresh
    model, under the same key paths as the dense LM's (``params/blocks/
    <layer>/ffn/<name>``, ``opt/m/blocks.<layer>.ffn.<name>``); the next
    step's loss is equal."""
    cfg = configs.get_smoke("mixtral-8x7b")
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=5)
    model, state = trainer.init_train_state(cfg, opt, seed=1, device="cpu")
    toks = np.arange(48).reshape(2, 24) % cfg.vocab_size
    batch = {"tokens": toks, "labels": (toks + 1) % cfg.vocab_size}
    step = trainer.make_step_fn(cfg, opt)
    model, state, _ = step(model, state, batch)
    ck = CheckpointManager(str(tmp_path), async_write=False)
    ck.save(1, {"params": model, "opt": state})
    with np.load(tmp_path / "step_00000001.npz") as z:
        keys = set(z.files)
        assert z["params/blocks/1/ffn/w_gate"].shape == (
            cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert f"params/blocks/0/ffn/{name}" in keys
        assert f"opt/m/blocks.0.ffn.{name}" in keys
        assert f"opt/v/blocks.1.ffn.{name}" in keys
    fresh, fstate = trainer.init_train_state(cfg, opt, seed=2, device="cpu")
    got = ck.restore(1, {"params": fresh, "opt": fstate}, device="cpu")
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              fresh.state_dict().items()):
        assert torch.equal(a, b), k
    for a, b in zip(_leaves(state), _leaves(got["opt"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    _, _, m1 = step(model, state, batch)
    _, _, m2 = step(fresh, got["opt"], batch)
    assert torch.equal(m1["loss"], m2["loss"])


def test_elastic_restore_new_sharding(tmp_path):
    """Arrays restore onto an explicitly given device, and a row-sharded
    layer's shards onto another mesh (the counterpart of placing on new
    shardings); a mesh of another shard count is refused."""
    ck = CheckpointManager(str(tmp_path), async_write=False)
    t = {"w": torch.arange(16.0).reshape(4, 4)}
    ck.save(1, t)
    got = ck.restore(1, t, device="cpu")
    assert torch.equal(got["w"], t["w"]) and got["w"].device.type == "cpu"

    mesh_a, mesh_b = make_mesh(4, "cpu"), make_mesh(4, "cpu")
    w = np.where(np.random.default_rng(0).random((24, 64)) < 0.3,
                 np.random.default_rng(1).normal(size=(24, 64)), 0.0)
    spec = SparseSpec("incrs", section=16, block=4, mesh=mesh_a)
    layer = Linear.from_dense(w, spec, device="cpu")
    ck.save(2, {"l": layer})
    tpl = Linear.from_dense(np.zeros_like(w) + w * 0.5, spec, device="cpu")
    ck.restore(2, {"l": tpl}, mesh=mesh_b)
    assert tpl.meta.mesh is mesh_b
    np.testing.assert_array_equal(tpl.to_dense(), layer.to_dense())
    with pytest.raises(ValueError, match="4-shard layer"):
        ck.restore(2, {"l": Linear.from_dense(w, spec, device="cpu")},
                   mesh=make_mesh(2, "cpu"))


def test_reprune_example_checkpoints_and_resumes(tmp_path, capsys):
    """The reprune example saves every step with the patterns and resumes
    halfway into a fresh dense model at the saved version."""
    from repro_torch.examples import train_reprune
    out = train_reprune.main(["--device", "cpu", "--ckpt-dir",
                              str(tmp_path)])
    text = capsys.readouterr().out
    assert out["mid_version"] > 0 and out["version"] > out["mid_version"]
    assert f"resuming at step 12 from {tmp_path}" in text
    assert "checkpoint -> resume -> deploy OK" in text
    man = json.loads((tmp_path / "manifest.json").read_text())
    assert man["steps"] == [23, 24]                   # keep=2
