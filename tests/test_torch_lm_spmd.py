"""``models.spmd``: placement, the four collectives and their counts, on
CPU meshes; the meta-device run's counts against a CPU run's; the
data-parallel gradient all-reduce's wire bytes; int8 moments quantized on
shards bit for bit as on one device; the long prefill's flash path once a
coordinate (logits within 1e-5 of max|logit| of one device).

The collectives' backward is checked as the adjoint of the forward: for
random x and y (float64), the sum over coordinates of <C(x), y> equals
the sum of <x, g>, g the gradient autograd gives through the collective's
backward. The wire bytes are JAX's ring formulas
(``repro.launch.dryrun.parse_collectives``).
"""
from __future__ import annotations

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401
import torch

from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import specs
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers as tlayers
from repro_torch.models import model as M
from repro_torch.models import sharding as sh
from repro_torch.models import spmd
from repro_torch.train import optimizer as O
from repro_torch.train import trainer as T
from repro_torch.train.zero import FSDP_OVERRIDES


def _mesh(shape, device="cpu", names=("data", "model")):
    return Mesh(np.full(shape, device, dtype=object), names[:len(shape)])


def _xs(mesh, shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g, dtype=torch.float64)
            for _ in range(mesh.size)]


def test_groups_follow_spec_order():
    mesh = _mesh((2, 4))
    assert spmd.groups(mesh, ("model",)) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert spmd.groups(mesh, ("data",)) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert spmd.groups(mesh, ("data", "model")) == [list(range(8))]
    assert spmd.groups(mesh, ("model", "data")) == [[0, 4, 1, 5, 2, 6, 3,
                                                     7]]
    with pytest.raises(ValueError, match="no axis"):
        spmd.groups(mesh, ("pod",))


def test_forwards_against_plain():
    mesh = _mesh((2, 4))
    xs = _xs(mesh, (4, 6))
    out = spmd.all_reduce(xs, mesh, ("model",))
    for i in range(8):
        grp = range(4 * (i // 4), 4 * (i // 4) + 4)
        assert torch.equal(out[i], xs[grp[0]] + xs[grp[1]] + xs[grp[2]] +
                           xs[grp[3]])
    out = spmd.all_gather(xs, mesh, ("data",), 1)
    assert torch.equal(out[5], torch.cat([xs[1], xs[5]], 1))
    out = spmd.reduce_scatter(xs, mesh, ("data",), 1)
    assert torch.equal(out[5], (xs[1] + xs[5])[:, 3:])
    out = spmd.all_to_all(xs, mesh, ("model",), 0, 1)
    # member j gets part j of every member's dim 0, concatenated on dim 1
    assert torch.equal(out[2], torch.cat([x[2:3] for x in xs[:4]], 1))
    mx = spmd.all_reduce_max(xs, mesh, ("data", "model"))
    assert torch.equal(mx[3], torch.stack(xs).amax(0))
    assert all(o is not x for o, x in zip(out, xs))


@pytest.mark.parametrize("kind", ["all_reduce", "all_gather",
                                  "reduce_scatter", "all_to_all"])
@pytest.mark.parametrize("axes", [("model",), ("data",), ("data", "model")])
def test_backward_is_the_adjoint(kind, axes):
    mesh = _mesh((2, 4))
    g = spmd.group_size(mesh, axes)
    xs = [x.requires_grad_() for x in _xs(mesh, (8, 16), 1)]
    fn = {"all_reduce": lambda v: spmd.all_reduce(v, mesh, axes),
          "all_gather": lambda v: spmd.all_gather(v, mesh, axes, 1),
          "reduce_scatter": lambda v: spmd.reduce_scatter(v, mesh, axes, 0),
          "all_to_all": lambda v: spmd.all_to_all(v, mesh, axes, 0, 1)}[kind]
    mesh.reset_collectives()
    out = fn(xs)
    ys = _xs(mesh, tuple(out[0].shape), 2)
    lhs = sum(float((o.detach() * y).sum()) for o, y in zip(out, ys))
    grads = torch.autograd.grad(sum((o * y).sum() for o, y in zip(out, ys)),
                                xs)
    rhs = sum(float((x.detach() * gr).sum()) for x, gr in zip(xs, grads))
    assert lhs == pytest.approx(rhs, rel=1e-12)
    adj = {"all_reduce": "all-reduce", "all_gather": "reduce-scatter",
           "reduce_scatter": "all-gather", "all_to_all": "all-to-all"}[kind]
    fwd = kind.replace("_", "-")
    assert mesh.collectives[fwd]["count"] == (2 if adj == fwd else 1)
    assert mesh.collectives[adj]["count"] == (2 if adj == fwd else 1)
    assert g > 1


def test_counts_and_wire_bytes():
    mesh = _mesh((2, 4))
    xs = _xs(mesh, (4, 8))              # 256 bytes each
    spmd.all_reduce(xs, mesh, ("model",))
    spmd.all_gather(xs, mesh, ("data",), 0)
    spmd.reduce_scatter(xs, mesh, ("model",), 1)
    spmd.all_to_all(xs, mesh, ("model",), 0, 1)
    spmd.all_reduce(xs, mesh, ())       # a group of one: nothing
    c = mesh.collectives
    assert c["all-reduce"] == {"count": 1, "result_bytes": 256,
                               "wire_bytes": 2 * 3 / 4 * 256}
    assert c["all-gather"] == {"count": 1, "result_bytes": 512,
                               "wire_bytes": 1 / 2 * 512}
    assert c["reduce-scatter"] == {"count": 1, "result_bytes": 64,
                                   "wire_bytes": 3 * 64}
    assert c["all-to-all"] == {"count": 1, "result_bytes": 256,
                               "wire_bytes": 3 / 4 * 256}
    mesh.reset_collectives()
    assert all(v["count"] == 0 for v in mesh.collectives.values())


def test_place_and_full():
    mesh = _mesh((2, 4))
    t = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    s = spmd.place(t, mesh, ("data", "model"))
    assert s.shards[5].shape == (4, 3)
    assert torch.equal(s.shards[5], t[4:8, 3:6])
    assert s.span(5, 1) == (3, 6)
    assert torch.equal(s.full(), t)
    r = spmd.place(t, mesh, (("data", "model"), None))
    assert torch.equal(r.shards[5], t[5:6]) and torch.equal(r.full(), t)
    with pytest.raises(ValueError, match="does not name"):
        spmd.place(t, mesh, ("data",))


def _step_counts(mesh, cfg, batch, opt, rules, kind):
    """The mesh's collectives of one sharded train step, prefill or decode
    on the smoke model (weights from the seed, or meta)."""
    model = (M.Model(cfg, device=specs.META) if mesh.device_list[0].type ==
             "meta" else M.init(cfg, seed=0, device="cpu"))
    sm = spmd.shard_model(model, mesh, rules)
    mesh.reset_collectives()
    if kind == "train":
        with sh.axis_rules(mesh, rules):
            step = T.build_train_step(cfg, opt, n_micro=2)
            step(sm, T.init_sharded_opt_state(opt, sm), batch)
    else:
        tok = batch["tokens"]
        with torch.no_grad():
            _, cache = M.prefill_step(sm, tok, alloc_seq=tok.shape[1] + 1)
            M.decode_step(sm, tok[:, :1], cache, pos=tok.shape[1])
    return mesh.collectives


@pytest.mark.parametrize("kind", ["train", "serve"])
@pytest.mark.parametrize("rules", [None, FSDP_OVERRIDES])
def test_meta_run_counts_equal_a_cpu_run(kind, rules, arch="granite-34b"):
    """The dry run's meta-device run (coordinate 0 alone) counts what a CPU
    run of every coordinate counts, kind by kind, to the byte."""
    cfg = configs.get_smoke(arch)
    opt = O.AdamWConfig(lr=1e-3, warmup_steps=0)
    cpu_b = {k: torch.as_tensor(v) for k, v in
             SyntheticTokens(cfg.vocab_size, 8, 32, seed=1).batch_at(0)
             .items()}
    meta_b = specs.batch_specs(cfg, ShapeSpec("b", 32, 8, "train"))
    cpu = _step_counts(_mesh((2, 4)), cfg, cpu_b, opt, rules, kind)
    meta = _step_counts(_mesh((2, 4), "meta"), cfg, meta_b, opt, rules,
                        kind)
    assert meta == cpu
    assert cpu["all-reduce"]["count"] > 0


MOE = ("mixtral-8x7b", "qwen2-moe-a2.7b")
FAMILY_RULES = {"default": None, "fsdp": FSDP_OVERRIDES,
                "ep": {"experts": "model"}}


@pytest.mark.parametrize("kind", ["train", "serve"])
@pytest.mark.parametrize("arch,rules", [
    (a, r) for a in MOE + ("mamba2-370m", "recurrentgemma-2b")
    for r in ("default", "fsdp") + (("ep",) if a in MOE else ())])
def test_meta_run_counts_equal_a_cpu_run_every_family(arch, rules, kind):
    """``test_meta_run_counts_equal_a_cpu_run`` for the MoE and recurrent
    families (and the EP rule for the MoE ones): the meta run reads no
    value, the MoE's routing included, and counts what a CPU run
    counts."""
    test_meta_run_counts_equal_a_cpu_run(kind, FAMILY_RULES[rules], arch)


def test_data_parallel_grad_all_reduce_wire_bytes():
    """A data-only mesh, no FSDP, no ZeRO-1: every gradient is all-reduced
    over data once, 2 (g - 1) / g of the parameters' (f32) bytes."""
    cfg = configs.get_smoke("llama3-405b")
    mesh = _mesh((4,), names=("data",))
    model = M.init(cfg, seed=0, device="cpu")
    sm = spmd.shard_model(model, mesh)
    opt = O.AdamWConfig()
    with sh.axis_rules(mesh):
        ms = T.moment_specs(opt, sm, zero1=False)
    batch = SyntheticTokens(cfg.vocab_size, 8, 16, seed=1).batch_at(0)
    _, parts = T.sharded_loss_and_grads(sm, batch)
    mesh.reset_collectives()
    T.reduce_grads(sm, parts, ms)
    pbytes = sum(p.numel() * 4 for p in model.parameters())
    c = mesh.collectives
    assert c["all-reduce"]["count"] == len(list(model.parameters()))
    assert c["all-reduce"]["wire_bytes"] == pytest.approx(
        2 * 3 / 4 * pbytes, rel=1e-12)
    assert c["all-gather"]["count"] == c["reduce-scatter"]["count"] == 0


@pytest.mark.parametrize("shape,spec", [
    ((4, 768), (None, "model")),        # 192 a shard: cuts JAX's blocks
    ((4, 1024), (None, "model")),       # 256 a shard: whole blocks
    ((8, 96), ("data", "model")),       # 96 % 256: one scale a row, cut
    ((8, 96), ("data", None)),          # one scale a row, whole
    ((1536,), ("model",)),              # a norm's moment under FSDP
])
def test_int8_shards_quantize_jax_blocks_bitwise(shape, spec):
    """Each shard's payload and scales equal the one-device quantization
    of the whole moment, bit for bit, where a shard boundary cuts a
    QBLOCK or a row's one scale (the block maxima all-reduced) and where
    it does not."""
    mesh = _mesh((2, 4))
    full = torch.randn(shape, generator=torch.Generator().manual_seed(4))
    full[..., 5] *= 40.0                 # one block's max far above
    q_want, s_want = O._quant(full)
    q = spmd.zeros(shape, torch.int8, mesh, spec)
    # the scales' spec as resolve gives it: their last dim splits where
    # whole blocks do
    g = spmd.group_size(mesh, sh.axes_of(spec[-1]))
    whole = shape[-1] % (O.QBLOCK * g) == 0
    s_spec = spec[:-1] + (spec[-1] if whole else None,)
    s = spmd.zeros(O.scale_shape(shape), torch.float32, mesh, s_spec)
    parts = [full[q.slices(i)] for i in range(mesh.size)]
    O._requant_sharded(parts, q, s)
    assert torch.equal(q.full(), q_want)
    assert torch.equal(s.full(), s_want)
    for i in range(mesh.size):
        assert torch.equal(O._dequant_shard(q, s, i),
                           O._dequant(q_want, s_want, shape)[q.slices(i)])


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# the long prefill's length: FLASH_THRESHOLD lowered to it (8,192 positions
# on the CPU took about a minute; the branch is the same at a few hundred)
LONG = 384


def test_long_prefill_runs_flash_once_a_coordinate(monkeypatch):
    """granite's smoke config (kv 1), (data 2, model 4), a prefill on the
    long side of ``FLASH_THRESHOLD`` (lowered to LONG positions for the
    test, so the branch is reached at a CPU's size): the flash path
    (``ops.flash_mha``, its plain version on the CPU) once a coordinate a
    layer, 8 x 2 = 16 calls, each on the coordinate's heads (1 kv head x
    1 query head); logits within 1e-5 of max|logit| of one device, before
    and after a decode step."""
    monkeypatch.setattr(tlayers, "FLASH_THRESHOLD", LONG)
    cfg = configs.get_smoke("granite-34b")
    model = M.init(cfg, seed=0, device="cpu")
    sm = spmd.shard_model(model, _mesh((2, 4)))
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, tlayers.FLASH_THRESHOLD)))
    alloc = tlayers.FLASH_THRESHOLD + 1
    l1, c1 = M.prefill_step(model, tok, alloc_seq=alloc,
                            cache_dtype=torch.float32)
    real, shapes = tlayers.ops.flash_mha, []

    def counted(q, k, v, **kw):
        shapes.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, **kw)
    monkeypatch.setattr(tlayers.ops, "flash_mha", counted)
    l2, c2 = M.prefill_step(sm, tok, alloc_seq=alloc,
                            cache_dtype=torch.float32)
    assert len(shapes) == 8 * cfg.n_layers
    assert set(shapes) == {((1, LONG, 1, 1, 16), (1, LONG, 1, 16))}
    assert _rel(l2.full(), l1) < 1e-5
    nt = tok[:, :1]
    l1, _ = M.decode_step(model, nt, c1, pos=tlayers.FLASH_THRESHOLD)
    l2, _ = M.decode_step(sm, nt, c2, pos=tlayers.FLASH_THRESHOLD)
    assert _rel(l2.full(), l1) < 1e-5
