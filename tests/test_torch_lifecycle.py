"""The sparsity lifecycle and the ``crs`` plan of the port, against the
JAX package, on the CPU.

``PruneSchedule``, ``sparsity_schedule``, ``prune_to_bsr``, ``repack``,
``magnitude_repack``, ``repack_onto``, the prune callback,
``prepare_versioned`` and the ``crs`` plan's metadata are host numpy in
both packages and are held bit for bit. Products (the ``crs`` plan at
every ``rhs_format``, the repacked layers' forward and gradients, the
engine after a swap) are held within ``TOL * max|ref|``: both sum in f32,
in another order.

The JAX InCRS layer cannot be differentiated or served on this tree
(ROADMAP fault C1: its ``auto`` variant reaches the pipelined Pallas
kernel, which calls the removed ``pl.load``), so the repacked InCRS layer
is held against the JAX pieces run with ``variant="expand"``, as
``test_torch_train.py`` does, and the engine swap against the dense
oracle. The port's kernels themselves are held on the card by
``test_torch_cuda_lifecycle.py`` and ``chip_smoke.py``.
"""
import dataclasses
import gc
import warnings

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401

torch = pytest.importorskip("torch")

import jax                                                # noqa: E402
import jax.numpy as jnp                                   # noqa: E402

from repro.core.crs import CRS as JCRS                    # noqa: E402
from repro.core.incrs import InCRS as JInCRS              # noqa: E402
from repro.kernels import ops as jops                     # noqa: E402
from repro.sparse import api as japi                      # noqa: E402
from repro.sparse import linear as jlin                   # noqa: E402
from repro.sparse import pattern as jpat                  # noqa: E402
from repro.sparse import prune as jprune                  # noqa: E402
from repro.train import optimizer as jopt                 # noqa: E402
from repro.train import trainer as jtrainer               # noqa: E402
from repro_torch import convert                           # noqa: E402
from repro_torch.core.crs import CRS as TCRS              # noqa: E402
from repro_torch.core.incrs import InCRS as TInCRS        # noqa: E402
from repro_torch.examples import train_reprune            # noqa: E402
from repro_torch.examples import train_unstructured as ex  # noqa: E402
from repro_torch.kernels import ops as tops               # noqa: E402
from repro_torch.serve import engine as tengine           # noqa: E402
from repro_torch.sparse import api as tapi                # noqa: E402
from repro_torch.sparse import linear as tlin             # noqa: E402
from repro_torch.sparse import pattern as tpat            # noqa: E402
from repro_torch.sparse import prune as tprune            # noqa: E402
from repro_torch.train import optimizer as topt           # noqa: E402
from repro_torch.train import trainer as ttrainer         # noqa: E402

TOL = 1e-4
CPU = torch.device("cpu")
KW = dict(section=32, block=8)          # the JAX lifecycle tests' geometry
BSR_BLOCK = 16


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, (err, scale)


def _normal(shape, seed, scale=1.0):
    return np.asarray(np.random.default_rng(seed).normal(size=shape) * scale,
                      np.float32)


def _spec(fmt, **kw):
    if fmt == "incrs":
        return dict(kw, **KW)
    if fmt == "bsr":
        return dict(kw, block=BSR_BLOCK)
    return kw


def _pair(fmt, w, **kw):
    """The same dense W packed by both packages under one spec: (port
    node, JAX node)."""
    kw = _spec(fmt, **kw)
    t = tapi.Linear.from_dense(w, tapi.SparseSpec(fmt, **kw),
                               device=CPU).inner
    j = japi.Linear.from_dense(w, japi.SparseSpec(fmt, **kw)).inner
    return t, j


def _same_node(t, j):
    """Port and JAX nodes bit for bit: values, pattern mask and version,
    and the family's index metadata."""
    assert type(t).__name__ == type(j).__name__
    assert np.array_equal(t.values.detach().numpy(), np.asarray(j.values))
    assert t.values.dtype == torch.float32
    tp, jp = tpat.get_pattern(t), jpat.get_pattern(j)
    assert np.array_equal(tp.mask, jp.mask) and tp.version == jp.version
    if isinstance(t, tlin.InCRSLinearParams):
        for f in ("fwd_idx", "bwd_idx", "t_gather"):
            assert np.array_equal(getattr(t.meta, f).numpy(),
                                  np.asarray(getattr(j.meta, f))), f
        assert t.meta.nnz == j.meta.nnz
    elif isinstance(t, tlin.SparseLinearParams):
        for f in ("row_of", "col_of", "vpos", "t_perm", "t_row_of",
                  "t_col_of", "t_vpos"):
            assert tuple(getattr(t.meta, f)) == tuple(getattr(j.meta, f)), f
    assert np.array_equal(tpat.node_to_dense(t), jpat.node_to_dense(j))


# ----------------------------------------------------------------------
# Schedules and pruning
SCHEDULES = [(0.25, 100, 0.1, 10), (0.15, 24, 0.2, 2), (1.0, 7, 0.0, 1),
             (0.05, 1, 0.5, 3), (0.5, 1000, 0.0, 7)]


@pytest.mark.parametrize("sched", SCHEDULES, ids=str)
def test_prune_schedule_is_the_jax_one(sched):
    t, j = tpat.PruneSchedule(*sched), jpat.PruneSchedule(*sched)
    for step in range(-2, sched[1] + 12):
        assert t.density_at(step) == j.density_at(step), step
        assert t.due(step) == j.due(step), step
        assert tprune.sparsity_schedule(step, *sched[1::-1], sched[2]) == \
            jprune.sparsity_schedule(step, *sched[1::-1], sched[2])


BAD_SCHEDULES = [dict(final_density=0.0, total_steps=100),
                 dict(final_density=1.5, total_steps=100),
                 dict(final_density=-0.5, total_steps=100),
                 dict(final_density=0.5, total_steps=0),
                 dict(final_density=0.5, total_steps=-10),
                 dict(final_density=0.5, total_steps=100, warmup_frac=1.0),
                 dict(final_density=0.5, total_steps=100, warmup_frac=-0.1),
                 dict(final_density=0.5, total_steps=100, every=0)]


@pytest.mark.parametrize("kw", BAD_SCHEDULES, ids=str)
def test_schedules_refuse_what_jax_refuses(kw):
    msgs = []
    for mod in (tpat, jpat):
        with pytest.raises(ValueError) as e:
            mod.PruneSchedule(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    if "every" not in kw:
        args = (0, kw["total_steps"], kw["final_density"],
                kw.get("warmup_frac", 0.1))
        for mod in (tprune, jprune):
            with pytest.raises(ValueError):
                mod.sparsity_schedule(*args)


def test_prune_schedule_cadence():
    """The JAX lifecycle test's schedule, step by step."""
    s = tpat.PruneSchedule(0.25, 100, warmup_frac=0.1, every=10)
    assert s.density_at(0) == 1.0
    assert s.density_at(100) == pytest.approx(0.25)
    assert not s.due(0) and not s.due(10)      # warmup: still dense
    assert s.due(20) and not s.due(25)
    assert tprune.sparsity_schedule(0, 1000, 0.25) == 1.0
    assert tprune.sparsity_schedule(1000, 1000, 0.25) == pytest.approx(0.25)


@pytest.mark.parametrize("density", [0.05, 0.3, 1.0])
@pytest.mark.parametrize("block", [8, 16])
def test_prune_to_bsr_is_the_jax_one(density, block):
    w = _normal((64, 96), 1)
    w[:block] = 0.0                            # an all-zero block-row
    t, j = tprune.prune_to_bsr(w, block, density), \
        jprune.prune_to_bsr(w, block, density)
    for f in ("values", "col_idx", "row_ptr"):
        assert np.array_equal(getattr(t, f), getattr(j, f)), f
    assert t.shape == j.shape and t.block == j.block
    assert np.all(np.diff(t.row_ptr) >= 1)     # no dead output block-row


# ----------------------------------------------------------------------
# repack, magnitude_repack and repack_onto, family by family
FAMILIES = ["incrs", "bsr", "dense"]


@pytest.mark.parametrize("fmt", FAMILIES)
@pytest.mark.parametrize("density", [0.5, 0.12])
def test_magnitude_repack_is_the_jax_one(fmt, density):
    w = _normal((64, 96), 2, 0.2)
    t, j = _pair(fmt, w, density=0.75)
    _same_node(t, j)
    t2, j2 = tpat.magnitude_repack(t, density), \
        jpat.magnitude_repack(j, density)
    assert t2 is not t and j2 is not j
    _same_node(t2, j2)
    assert tpat.get_pattern(t2).version == 1
    assert tpat.get_pattern(t2).uid == tpat.get_pattern(t).uid
    assert tpat.get_pattern(t).version == 0     # the old node untouched
    assert t2.values.device == t.values.device
    t3, j3 = tpat.magnitude_repack(t2, density / 2), \
        jpat.magnitude_repack(j2, density / 2)
    _same_node(t3, j3)
    assert tpat.get_pattern(t3).version == 2


@pytest.mark.parametrize("density", [0.01, 0.1, 0.3, 0.6, 0.999])
@pytest.mark.parametrize("zeros", [0.0, 0.5, 0.95, 1.0])
def test_magnitude_mask_is_the_jax_one_on_mostly_zero_weights(density,
                                                              zeros):
    """The threshold is taken over the non-zeros alone: the same mask as
    JAX's over every element, ties and a keep count past the non-zeros
    included."""
    rng = np.random.default_rng(int(density * 1000) + int(zeros * 10))
    w = _normal((48, 80), 42) * (rng.random((48, 80)) >= zeros)
    w[:4] = np.round(w[:4])                    # ties at the threshold
    assert np.array_equal(tpat.magnitude_mask(w, density),
                          jpat.magnitude_mask(w, density))


@pytest.mark.parametrize("fmt", ["incrs", "dense"])
@pytest.mark.parametrize("policy", ["2:4", "1:4"])
def test_nm_repack_is_the_jax_one(fmt, policy):
    t, j = _pair(fmt, _normal((64, 96), 3), density=0.9)
    t2 = tpat.magnitude_repack(t, 0.1, policy=policy)
    j2 = jpat.magnitude_repack(j, 0.1, policy=policy)
    _same_node(t2, j2)
    n, m = tpat.parse_nm(policy)
    groups = tpat.get_pattern(t2).mask.reshape(64 // m, m, 96).sum(axis=1)
    assert np.all(groups == n)


def test_nm_repack_is_refused_for_bsr():
    t, j = _pair("bsr", _normal((64, 64), 4), density=0.75)
    for mod, node in ((tpat, t), (jpat, j)):
        with pytest.raises(ValueError, match="prunes whole blocks"):
            mod.magnitude_repack(node, 0.5, policy="2:4")
    with pytest.raises(ValueError, match="n:m"):
        tpat.magnitude_repack(t, 0.5, policy="two:four")


@pytest.mark.parametrize("fmt", FAMILIES)
def test_repack_with_a_mask_that_keeps_zero_slots(fmt):
    """A slot the new mask keeps stays live even at value exactly 0.0,
    and gets a gradient."""
    w = _normal((32, 32), 5)
    t, j = _pair(fmt, w, density=0.5)
    mask = tpat.get_pattern(t).mask.copy()
    rng = np.random.default_rng(6)
    mask[:16, :16] = False                     # prune a corner ...
    mask[16:, 16:] = rng.random((16, 16)) < 0.5
    mask[0, 0] = True                          # ... and revive a pruned slot
    if fmt == "bsr":
        mask = tpat.expand_block_mask(
            tpat.SparsityPattern(mask).block_mask(BSR_BLOCK), BSR_BLOCK)
    t2, j2 = tpat.repack(t, mask), jpat.repack(j, mask)
    _same_node(t2, j2)
    assert tpat.get_pattern(t2).nnz == int(mask.sum())
    w2 = tpat.node_to_dense(t2)
    revived = mask & ~tpat.get_pattern(t).mask
    assert revived.any() and np.all(w2[revived] == 0.0)
    kept = mask & tpat.get_pattern(t).mask
    assert np.array_equal(w2[kept], tpat.node_to_dense(t)[kept])
    lin = tapi.Linear(t2)
    (lin(torch.ones(4, 32)).sum()).backward()
    gd = lin.to_dense(lin.values.grad)
    assert np.all(gd[revived] != 0.0)          # zero-valued live slots
    assert np.all(gd[~mask] == 0.0)


@pytest.mark.parametrize("fmt", FAMILIES)
def test_repack_to_the_same_mask_bumps_the_version_and_keeps_outputs(fmt):
    w = np.where(np.random.default_rng(7).random((64, 96)) < 0.2,
                 _normal((64, 96), 8), 0.0).astype(np.float32)
    t, j = _pair(fmt, w, **({"mask": w != 0} if fmt == "dense" else {}))
    x = torch.from_numpy(_normal((8, 64), 9))
    y1 = tapi.apply(t, x)
    t2 = tpat.repack(t, tpat.get_pattern(t).mask)
    j2 = jpat.repack(j, jpat.get_pattern(j).mask)
    _same_node(t2, j2)
    assert tpat.get_pattern(t2).version == 1
    assert torch.equal(tapi.apply(t2, x), y1)
    t3 = tpat.repack(t, tpat.get_pattern(t).mask, version=7)
    assert tpat.get_pattern(t3).version == 7


@pytest.mark.parametrize("fmt", FAMILIES)
def test_magnitude_repack_noop_returns_the_same_object(fmt):
    t, j = _pair(fmt, _normal((64, 64), 10), density=0.25)
    assert tpat.magnitude_repack(t, 0.25) is t
    assert jpat.magnitude_repack(j, 0.25) is j
    assert tpat.get_pattern(t).version == 0


def test_bsr_repack_keeps_dead_blocks_dead():
    """A generous density must not revive all-zero blocks."""
    t, _ = _pair("bsr", _normal((64, 64), 11), density=0.25)
    assert tpat.magnitude_repack(t, 0.99) is t
    w = tpat.node_to_dense(t)
    assert np.array_equal(tpat.magnitude_mask(w, 0.99, block=BSR_BLOCK),
                          tpat.get_pattern(t).mask)
    t2 = tpat.magnitude_repack(t, 0.1)
    pat2 = tpat.get_pattern(t2)
    assert np.array_equal(pat2.mask, tpat.expand_block_mask(
        pat2.block_mask(BSR_BLOCK), BSR_BLOCK))
    x = torch.from_numpy(_normal((4, 64), 12))
    _close(tapi.apply(t2, x).numpy(),
           x.numpy().astype(np.float64) @ tpat.node_to_dense(t2))


@pytest.mark.parametrize("fmt", FAMILIES)
def test_repack_onto_moves_moments_as_jax_does(fmt):
    w = _normal((64, 96), 13, 0.2)
    t, j = _pair(fmt, w, density=0.6)
    mom = _normal(tuple(t.values.shape), 14)
    tm = dataclasses.replace(t, values=torch.from_numpy(mom))
    jm = dataclasses.replace(j, values=jnp.asarray(mom))
    t2, j2 = tpat.magnitude_repack(t, 0.2), jpat.magnitude_repack(j, 0.2)
    tm2, jm2 = tpat.repack_onto(tm, t2), jpat.repack_onto(jm, j2)
    assert tm2.meta is t2.meta
    assert np.array_equal(tm2.values.numpy(), np.asarray(jm2.values))
    assert tm2.values.dtype == torch.float32
    new = tpat.get_pattern(t2).mask
    old = tpat.get_pattern(t).mask
    md_old, md_new = tpat.node_to_dense(tm), tpat.node_to_dense(tm2)
    assert np.array_equal(md_new[new & old], md_old[new & old])
    assert np.all(md_new[~new] == 0.0)
    with pytest.raises(TypeError, match="repack_onto"):
        other = _pair("dense" if fmt != "dense" else "incrs", w)[0]
        tpat.repack_onto(tm, other)


def test_lifecycle_predicates_and_registry():
    t, _ = _pair("incrs", _normal((32, 32), 15), density=0.5)
    assert tpat.is_lifecycle_node(t) and not tpat.is_stacked_node(t)
    stacked = dataclasses.replace(t, values=torch.stack([t.values] * 2))
    assert tpat.is_stacked_node(stacked)
    assert not tpat.is_lifecycle_node(stacked)
    plain = tapi.Linear.from_dense(_normal((8, 8), 16),
                                   tapi.SparseSpec("dense"), device=CPU)
    assert not tpat.is_lifecycle_node(plain.inner)   # no pattern
    assert not tpat.is_lifecycle_node(object())
    with pytest.raises(TypeError, match="not a registered"):
        tpat.node_to_dense(object())
    with pytest.raises(ValueError, match="no SparsityPattern"):
        tpat.repack(plain.inner, np.ones((8, 8), bool))


# ----------------------------------------------------------------------
# The prune callback
def _carry(jl, fmt):
    """The port's Linear from a JAX Linear, pattern version included."""
    fields = {f.name: getattr(jl.meta, f.name)
              for f in dataclasses.fields(jl.meta) if f.name != "pattern"}
    fields = {f: (np.asarray(v) if hasattr(v, "shape") else v)
              for f, v in fields.items()}
    fields["pattern"] = jl.pattern
    return convert.linear_from_jax(np.asarray(jl.values), fields, fmt,
                                   device=CPU)


def _moments_like(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda v: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)),
        params)


# bsr prunes whole blocks: its n:m refusal is tested apart
@pytest.mark.parametrize("fmt, policy", [
    ("incrs", "magnitude"), ("bsr", "magnitude"), ("dense", "magnitude"),
    ("incrs", "2:4"), ("dense", "2:4")])
def test_prune_callback_is_the_jax_one(fmt, policy):
    spec = japi.SparseSpec(fmt, density=0.8 if fmt != "dense" else None,
                           **_spec(fmt))
    if fmt == "dense":
        spec = dataclasses.replace(spec, mask=np.ones((64, 96), bool))
    jparams = {"l1": japi.Linear.from_dense(_normal((64, 96), 17, 0.2), spec),
               "l2": japi.Linear.from_dense(_normal((96, 32), 18, 0.2),
                                            dataclasses.replace(
                                                spec, mask=None,
                                                density=0.8)
                                            if fmt == "dense" else spec)}
    jcfg = jopt.AdamWConfig(lr=1e-2, weight_decay=0.0, warmup_steps=1,
                            total_steps=10)
    jstate = dict(jopt.adamw_init(jcfg, jparams),
                  m=_moments_like(jparams, 19), v=_moments_like(jparams, 20))
    model = torch.nn.ModuleDict({k: _carry(v, fmt)
                                 for k, v in jparams.items()})
    tstate = convert.adamw_state_from_jax(
        {"m": {f"{k}.values": np.asarray(jstate["m"][k].values)
               for k in jparams},
         "v": {f"{k}.values": np.asarray(jstate["v"][k].values)
               for k in jparams},
         "count": np.asarray(jstate["count"])}, device=CPU)
    sched = (0.2, 10, 0.1, 2)
    jcb = jtrainer.make_prune_callback(jpat.PruneSchedule(*sched),
                                       policy=policy)
    tcb = ttrainer.make_prune_callback(tpat.PruneSchedule(*sched),
                                       policy=policy)
    for step in range(0, 7):
        before = dict(model.named_parameters())
        jparams, jstate, jinfo = jcb(step, jparams, jstate)
        tinfo = tcb(step, model, tstate)
        assert tinfo == jinfo, step
        after = dict(model.named_parameters())
        assert list(after) == ["l1.values", "l2.values"]
        for k in jparams:
            _same_node(model[k].inner, jparams[k].inner)
            for mom in ("m", "v"):
                assert np.array_equal(
                    tstate[mom][f"{k}.values"].numpy(),
                    np.asarray(jstate[mom][k].values)), (step, k, mom)
            if tinfo is None:
                assert after[f"{k}.values"] is before[f"{k}.values"]
    assert model["l1"].pattern.version == jparams["l1"].pattern.version > 0


def test_prune_callback_keeps_surviving_moments_and_resets_new_ones():
    """Every live slot of an all-live layer has moment 1; after the
    re-prune the surviving slots keep it and the packed moment holds
    nothing outside the new live set; a step then updates the NEW
    tensor."""
    lin = tapi.Linear.from_dense(_normal((64, 64), 21, 0.2),
                                 tapi.SparseSpec("incrs", density=1.0, **KW),
                                 device=CPU)
    model = torch.nn.ModuleDict({"l1": lin})
    cfg = topt.AdamWConfig(lr=1e-2, weight_decay=0.0, warmup_steps=0,
                           total_steps=10)
    params = dict(model.named_parameters())
    live = lin.meta.fwd_idx >= 0
    state = topt.adamw_init(cfg, params)
    state["m"]["l1.values"] = live.float()
    state["v"]["l1.values"] = live.float()
    cb = ttrainer.make_prune_callback(tpat.PruneSchedule(0.25, 10,
                                                         warmup_frac=0.1,
                                                         every=2))
    old = lin.values
    info = cb(2, model, state)
    assert info is not None and info["layers"] == 1
    assert info["nnz"] == lin.pattern.nnz and lin.pattern.version == 1
    new_live = lin.meta.fwd_idx >= 0
    m = state["m"]["l1.values"]
    assert m.shape == lin.values.shape
    assert bool((m[new_live] == 1.0).all()) and bool((m[~new_live] == 0).all())
    assert lin.values is not old
    params = dict(model.named_parameters())
    assert params["l1.values"] is lin.values
    before = lin.values.detach().clone()
    x = torch.from_numpy(_normal((8, 64), 22))
    loss = (lin(x) ** 2).mean()
    (g,) = torch.autograd.grad(loss, [params["l1.values"]])
    topt.adamw_update(cfg, {"l1.values": g}, state, params)
    assert not torch.equal(lin.values.detach(), before)
    assert bool((lin.values.detach()[~new_live] == 0.0).all())


def test_prune_callback_refuses_int8_moments_and_skips_stacked():
    lin = tapi.Linear.from_dense(_normal((64, 64), 23, 0.2),
                                 tapi.SparseSpec("incrs", density=1.0, **KW),
                                 device=CPU)
    model = torch.nn.ModuleDict({"l1": lin})
    cfg = topt.AdamWConfig(quantize=True)
    state = topt.adamw_init(cfg, dict(model.named_parameters()))
    cb = ttrainer.make_prune_callback(tpat.PruneSchedule(0.25, 10,
                                                         every=2))
    with pytest.raises(ValueError, match="unquantized"):
        cb(4, model, state)
    stacked = tapi.Linear(dataclasses.replace(
        lin.inner, values=torch.stack([lin.values.detach()] * 2)))
    smodel = torch.nn.ModuleDict({"s": stacked})
    sstate = topt.adamw_init(topt.AdamWConfig(),
                             dict(smodel.named_parameters()))
    with pytest.warns(UserWarning, match="stacked"):
        assert cb(4, smodel, sstate) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")           # warned once only
        assert cb(6, smodel, sstate) is None
    assert cb(3, model, state) is None           # not due
    with pytest.raises(ValueError, match="n:m"):
        ttrainer.make_prune_callback(tpat.PruneSchedule(0.25, 10),
                                     policy="2-4")


def _jax_incrs_grads(jl, x, y):
    """Loss gradients of the 2-layer student from the JAX pieces run with
    ``variant="expand"`` (C1 stops ``jax.grad`` of the JAX InCRS layer)."""
    def fwd(p, xx):
        prep = jops.PreparedOperand(p.meta.fwd_idx, p.values,
                                    (p.meta.d_out, p.meta.d_in),
                                    p.meta.section)
        return jops.spmm(prep, xx.T, variant="expand").T
    p1, p2 = jl["l1"].inner, jl["l2"].inner
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    h = jnp.tanh(fwd(p1, xj))
    out = fwd(p2, h)
    dout = 2.0 * (out - yj) / out.size
    flat = jnp.concatenate([p2.values.reshape(-1),
                            jnp.zeros((1,), p2.values.dtype)])
    tprep = jops.PreparedOperand(
        p2.meta.bwd_idx, flat[p2.meta.t_gather].reshape(p2.meta.bwd_idx.shape),
        (p2.meta.d_in, p2.meta.d_out), p2.meta.section)
    dh = jops.spmm(tprep, dout.T, variant="expand").T
    dw2 = jlin._stripe_dw(p2.meta.fwd_idx, p2.meta.section, h, dout)
    dw1 = jlin._stripe_dw(p1.meta.fwd_idx, p1.meta.section, xj,
                          dh * (1 - h * h))
    return np.asarray(out), {"l1": np.asarray(dw1), "l2": np.asarray(dw2)}


def test_repacked_incrs_layers_match_the_jax_composition():
    """Three re-prunes through both callbacks, then the port's forward
    and gradients against the JAX pieces (``variant="expand"``) on the
    repacked stripes, and against float64 restricted to the new live
    set."""
    spec = japi.SparseSpec("incrs", density=1.0, **KW)
    jl = {"l1": japi.Linear.from_dense(_normal((64, 96), 24, 0.2), spec),
          "l2": japi.Linear.from_dense(_normal((96, 32), 25, 0.2), spec)}
    jstate = jopt.adamw_init(jopt.AdamWConfig(), jl)
    model = torch.nn.ModuleDict({k: _carry(v, "incrs")
                                 for k, v in jl.items()})
    tstate = topt.adamw_init(topt.AdamWConfig(),
                             dict(model.named_parameters()))
    sched = (0.2, 10, 0.1, 2)
    jcb = jtrainer.make_prune_callback(jpat.PruneSchedule(*sched))
    tcb = ttrainer.make_prune_callback(tpat.PruneSchedule(*sched))
    for step in (2, 4, 6):
        jl, jstate, _ = jcb(step, jl, jstate)
        assert tcb(step, model, tstate) is not None
    assert model["l1"].pattern.version == 3
    x, y = _normal((16, 64), 26), _normal((16, 32), 27)
    jout, jgrads = _jax_incrs_grads(jl, x, y)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    h = torch.tanh(model["l1"](xt))
    out = model["l2"](h)
    _close(out.detach().numpy(), jout)
    loss = torch.mean((out - yt) ** 2)
    grads = torch.autograd.grad(loss, [model[k].values for k in ("l1", "l2")])
    for k, g in zip(("l1", "l2"), grads):
        _close(g.numpy(), jgrads[k])
    errs = ex.grad_errors(model, xt, yt)       # float64, new live set
    assert max(errs.values()) <= TOL, errs


# ----------------------------------------------------------------------
# Versioned prep
def test_versioned_prep_invalidates_on_a_repack():
    d = np.where(np.random.default_rng(28).random((64, 128)) < 0.1,
                 _normal((64, 128), 29), 0.0).astype(np.float32)
    pat = tpat.SparsityPattern(d != 0)
    inc = TInCRS.from_crs(TCRS.from_mask(d, pat.mask))
    p1 = tops.prepare_incrs(inc, pattern=pat, device=CPU)
    assert tops.prepare_incrs(inc, pattern=pat, device=CPU) is p1
    pat2 = pat.evolve(tpat.magnitude_mask(d, 0.05))
    d2 = np.where(pat2.mask, d, 0.0)
    inc2 = TInCRS.from_crs(TCRS.from_mask(d2, pat2.mask))
    p2 = tops.prepare_incrs(inc2, pattern=pat2, device=CPU)
    assert p2 is not p1
    assert tops.prepare_incrs(inc2, pattern=pat2, device=CPU) is p2
    _close(tops.spmm(p2, torch.eye(128)).numpy(), d2)
    jpat2 = jpat.SparsityPattern(pat2.mask, version=pat2.version)
    jinc2 = JInCRS.from_crs(JCRS.from_mask(d2, pat2.mask))
    jp2 = jops.prepare_incrs(jinc2, pattern=jpat2)
    assert np.array_equal(p2.idx.numpy(), np.asarray(jp2.idx))
    assert np.array_equal(p2.val.numpy(), np.asarray(jp2.val))
    tops.invalidate_pattern(pat2)
    assert tops.prepare_incrs(inc2, pattern=pat2, device=CPU) is not p2


def test_versioned_prep_guards_the_source_identity():
    """Values change WITHOUT a version bump while training on a fixed
    pattern: an InCRS rebuilt from updated weights must miss."""
    d = np.where(np.random.default_rng(30).random((32, 64)) < 0.2,
                 _normal((32, 64), 31), 0.0).astype(np.float32)
    pat = tpat.SparsityPattern(d != 0)
    inc = TInCRS.from_crs(TCRS.from_mask(d, pat.mask))
    p1 = tops.prepare_incrs(inc, pattern=pat, device=CPU)
    inc2 = TInCRS.from_crs(TCRS.from_mask(d * 2.0, pat.mask))
    p2 = tops.prepare_incrs(inc2, pattern=pat, device=CPU)
    assert p2 is not p1
    assert torch.equal(p2.val, 2.0 * p1.val)
    built = []
    tok = TInCRS.from_crs(TCRS.from_mask(d, pat.mask))
    for flavor in ("a", "a", "b"):
        tops.prepare_versioned(pat, flavor, lambda: built.append(1) or
                               len(built), token=tok)
    assert len(built) == 2                     # "a" hit once, "b" built
    del tok
    gc.collect()
    tops.prepare_versioned(pat, "a", lambda: built.append(1), token=inc)
    assert len(built) == 3                     # a dead token misses


# ----------------------------------------------------------------------
# The crs plan
def _crs_operand(m, k, density, seed, *, empty_rows=()):
    rng = np.random.default_rng(seed)
    a = np.where(rng.random((m, k)) < density,
                 rng.uniform(0.5, 1.5, (m, k)), 0.0).astype(np.float32)
    a[list(empty_rows)] = 0.0
    return a


CRS_META_CASES = [  # (label, M, K, density, rounds)
    ("small_r32", 70, 300, 0.1, 32),
    ("small_r128", 70, 300, 0.1, 128),
    ("rows_over_128", 200, 257, 0.05, 64),
    ("dense_rows", 33, 96, 0.9, 32),
    ("empty", 20, 64, 0.0, 32),
]


@pytest.mark.parametrize("case", CRS_META_CASES, ids=lambda c: c[0])
def test_crs_plan_meta_and_pack_are_the_jax_ones(case):
    _, m, k, density, rounds = case
    a = _crs_operand(m, k, density, 32, empty_rows=(0, 5))
    w = np.ascontiguousarray(a.T)
    pat = tpat.SparsityPattern(a.T != 0)
    t = tapi._crs_plan_meta(pat, rounds, "crs")
    j = japi._crs_plan_meta(jpat.SparsityPattern(a.T != 0), rounds, "crs")
    assert t.ai.dtype == torch.int32 and t.scatter.dtype == torch.int32
    assert np.array_equal(t.ai.numpy(), np.asarray(j.ai))
    assert np.array_equal(t.scatter.numpy(), np.asarray(j.scatter))
    assert t.ai.shape[0] % 128 == 0 and t.shape == j.shape == (m, k)
    assert t.scatter.numel() == int((a != 0).sum())
    assert np.array_equal(tapi._crs_pack(t, w), np.asarray(japi._crs_pack(
        j, w)))
    # every value lands in the slot prep_rounds gives it
    vals = tapi._crs_pack(t, w)
    _, av = tapi._crs_ready(t, torch.from_numpy(vals))
    _, want = tops.prep_rounds(TCRS.from_dense(a), rounds, device=CPU)
    assert torch.equal(av, want)


RHS_FORMATS = [None, "dense", "crs", "incrs"]


@pytest.mark.parametrize("rhs_format", RHS_FORMATS)
@pytest.mark.parametrize("rounds", [32, 128])
def test_crs_plan_matches_jax_at_every_rhs_format(rhs_format, rounds):
    a = _crs_operand(70, 300, 0.1, 33, empty_rows=(3,))
    bt = _crs_operand(45, 300, 0.08, 34)
    tb, jb = TCRS.from_dense(bt), JCRS.from_dense(bt)
    tspec = tapi.SparseSpec("crs", rounds=rounds, rhs_format=rhs_format)
    jspec = japi.SparseSpec("crs", rounds=rounds, rhs_format=rhs_format)
    tp = tapi.plan_for_operand(a, tspec, device=CPU)
    jp = japi.plan_for_operand(a, jspec)
    assert tp.shape == jp.shape == (70, 300)
    assert np.array_equal(tp.values.numpy(), np.asarray(jp.values))
    got = tp(tb)
    assert got.shape == (70, 45) and got.dtype == torch.float32
    want = np.asarray(jp(jb, interpret=True))
    _close(got.numpy(), want)
    _close(got.numpy(), a.astype(np.float64) @ bt.T.astype(np.float64))
    # condense + merge bitwise equal to index matching on the plan's
    # operands; the reference override; an InCRS right-hand side; and
    # ops.spmm through index matching (its "auto" picks by the cost
    # model, and densify sums in another order)
    ref = tp(tb, variant="reference")
    assert torch.equal(got, ref)
    assert torch.equal(tp(TInCRS.from_crs(tb)), got)
    assert torch.equal(got, tops.spmm(TCRS.from_dense(a), tb, rounds=rounds,
                                      variant="reference", device=CPU))


def test_crs_plan_binds_once_and_memoizes_the_rhs():
    a = _crs_operand(70, 300, 0.1, 35)
    w = np.ascontiguousarray(a.T)
    p = tapi.plan(tapi.SparseSpec("crs", mask=w != 0, rounds=32), (300, 9))
    assert p.shape == (70, 300) and p.pattern.nnz == int((a != 0).sum())
    bound = p.bind(p.pack(w), device=CPU)
    ai, av = bound._ready
    assert ai.shape == av.shape and av.dtype == torch.float32
    bs = [TCRS.from_dense(_crs_operand(9, 300, 0.1, 40 + i))
          for i in range(10)]
    calls = []
    real = tops.prep_rounds

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    try:
        tops.prep_rounds = counting
        c1 = bound(bs[0])
        c2 = bound(bs[0])
        assert len(calls) == 1 and torch.equal(c1, c2)
        for b in bs:
            bound(b)
        assert len(calls) == 10
        assert len(p.meta._rhs_prep) == tapi._RHS_PREP_MAX
        bound(bs[0])                       # evicted: the oldest went first
        assert len(calls) == 11
        del bs[1:]
        gc.collect()
        # a recycled id of a dead object is not a hit (weakref guard)
        dead = [v for v in p.meta._rhs_prep.values() if v[0]() is None]
        assert dead
    finally:
        tops.prep_rounds = real
    _close(c1.numpy(), a.astype(np.float64) @ bs[0].to_dense().T)
    # the unbound plan runs on values too
    assert torch.equal(p(torch.from_numpy(p.pack(w)), bs[0]), c1)


def test_crs_format_refusals():
    w = _crs_operand(40, 64, 0.2, 36)
    spec = tapi.SparseSpec("crs", mask=w != 0)
    for mod in (tapi, japi):
        with pytest.raises(ValueError, match="plan–execute only"):
            mod.Linear.from_dense(w, mod.SparseSpec("crs", mask=w != 0))
    with pytest.raises(ValueError, match="rhs_format must be"):
        tapi.SparseSpec("crs", rhs_format="bsr")
    with pytest.raises(ValueError, match="needs format='crs'"):
        tapi.SparseSpec("incrs", rhs_format="crs")
    tapi.SparseSpec("bsr", block=8, rhs_format="dense")   # allowed
    bound = tapi.plan_for_operand(w.T, spec, device=CPU)
    with pytest.raises(TypeError, match="needs B\\^T as a CRS"):
        bound(np.ones((64, 3), np.float32))
    with pytest.raises(ValueError, match="inner dims"):
        bound(TCRS.from_dense(np.ones((3, 65), np.float32)))
    with pytest.raises(ValueError, match="one value per slot"):
        bound.plan.bind(torch.zeros(3), device=CPU)
    with pytest.raises(ValueError, match="'auto' or 'reference'"):
        bound(TCRS.from_dense(np.ones((3, 64), np.float32)),
              variant="condense_merge")
    bsr = tapi.plan_for_operand(w.T[:32, :32].copy(),
                                tapi.SparseSpec("bsr", block=8), device=CPU)
    with pytest.raises(ValueError, match="takes no variant"):
        bsr(np.ones((32, 2), np.float32), variant="reference")
    eng_op = tapi.plan_for_operand(w.T, spec, device=CPU)
    with pytest.raises(ValueError, match="crs plan"):
        tengine.SpMMEngine(eng_op, device="cpu")


# ----------------------------------------------------------------------
# Serving: the hot swap of a repacked operand
@pytest.mark.parametrize("fmt", FAMILIES)
def test_engine_swaps_a_repacked_layer(fmt):
    lin = tapi.Linear.from_dense(
        _normal((96, 64), 37, 0.3),
        tapi.SparseSpec(fmt, **_spec(fmt, density=0.5)) if fmt != "dense"
        else tapi.SparseSpec("dense", mask=np.ones((96, 64), bool)),
        device=CPU)
    eng = tengine.SpMMEngine(lin, max_wave_cols=128)
    assert eng.pattern_version == 0
    rng = np.random.default_rng(38)

    def serve(rid, want_w):
        b = rng.normal(size=(96, 16)).astype(np.float32)
        eng.submit(tengine.SpMMRequest(rid, b))
        out = [r for r in eng.run() if r.rid == rid][0].out
        _close(out, want_w.astype(np.float64).T @ b)

    w0 = lin.to_dense()
    serve(0, w0)
    new = tpat.magnitude_repack(lin.inner, 0.2)
    # a wave launched before the swap keeps the operand it launched with
    b1 = rng.normal(size=(96, 8)).astype(np.float32)
    eng.submit(tengine.SpMMRequest(1, b1))
    eng.step(retire=False)
    eng.swap_pattern(tapi.Linear(new))
    assert eng.pattern_version == 1 and eng.stats["pattern_swaps"] == 1
    eng.run()
    inflight = [r for r in eng.finished if r.rid == 1][0]
    _close(inflight.out, w0.astype(np.float64).T @ b1)
    serve(2, tpat.node_to_dense(new))
    lin.set_inner(new)
    eng.swap_pattern(lin.bound())
    assert eng.pattern_version == 1 and eng.stats["pattern_swaps"] == 2
    serve(3, lin.to_dense())


def test_rejected_swap_leaves_the_old_operand_serving():
    lin = tapi.Linear.from_dense(_normal((96, 64), 39),
                                 tapi.SparseSpec("incrs", density=0.5, **KW),
                                 device=CPU)
    other = tapi.Linear.from_dense(_normal((64, 64), 39),
                                   tapi.SparseSpec("incrs", density=0.5,
                                                   **KW), device=CPU)
    eng = tengine.SpMMEngine(lin)
    old_a, old_prep = eng.a, eng.prep
    with pytest.raises(ValueError, match="serving shape"):
        eng.swap_pattern(other)
    assert eng.a is old_a and eng.prep is old_prep
    with pytest.raises(ValueError, match="bind values"):
        eng.swap_pattern(lin.plan)
    assert eng.a is old_a and eng.prep is old_prep
    b = _normal((96, 8), 40)
    eng.submit(tengine.SpMMRequest(0, b))
    _close(eng.run()[0].out, lin.to_dense().astype(np.float64).T @ b)
    assert eng.stats["pattern_swaps"] == 0 and eng.pattern_version == 0
    with pytest.raises(TypeError, match="set_inner|cannot take"):
        lin.set_inner(tlin.SparseLinearParams(None, None))


@pytest.mark.parametrize("fmt", FAMILIES)
def test_a_training_step_does_not_reach_the_served_operand(fmt):
    """JAX values never change under a bound plan; the port's AdamW
    writes the Parameter in place, so the engine serves a copy: the
    weight from before the step until the swap."""
    lin = tapi.Linear.from_dense(
        _normal((96, 64), 42, 0.3),
        tapi.SparseSpec(fmt, **_spec(fmt, density=0.5)) if fmt != "dense"
        else tapi.SparseSpec("dense", mask=_normal((96, 64), 43) > 0),
        device=CPU)
    eng = tengine.SpMMEngine(lin, max_wave_cols=128)
    rng = np.random.default_rng(44)

    def serve(rid, want_w):
        b = rng.normal(size=(96, 16)).astype(np.float32)
        eng.submit(tengine.SpMMRequest(rid, b))
        out = [r for r in eng.run() if r.rid == rid][0].out
        _close(out, want_w.astype(np.float64).T @ b)

    w0 = lin.to_dense()
    serve(0, w0)
    cfg = topt.AdamWConfig(lr=1e-2, weight_decay=0.0, warmup_steps=0,
                           total_steps=10)
    params = dict(torch.nn.ModuleDict({"l1": lin}).named_parameters())
    state = topt.adamw_init(cfg, params)
    x, y = torch.from_numpy(_normal((8, 96), 45)), torch.zeros(8, 64)
    loss = (lin(x) - y).pow(2).mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    topt.adamw_update(cfg, dict(zip(params, grads)), state, params)
    w1 = lin.to_dense()
    assert not np.array_equal(w1, w0)          # the step moved the weight
    serve(1, w0)
    eng.swap_pattern(lin)
    serve(2, w1)


# ----------------------------------------------------------------------
def test_pattern_from_jax_carries_mask_and_version():
    jp = jpat.SparsityPattern(np.random.default_rng(41).random((8, 12)) < .5,
                              version=4)
    tp = convert.pattern_from_jax(jp)
    assert np.array_equal(tp.mask, jp.mask) and tp.version == 4
    assert tp.evolve(tp.mask).version == jp.evolve(jp.mask).version == 5


def test_the_reprune_example_runs():
    out = train_reprune.main(["--device", "cpu", "--steps", "12"])
    assert out["version"] > 0 and out["swaps"] == 1
    assert out["density"] <= 0.15 + 0.02
    assert out["served_err"] <= train_reprune.SERVE_TOL
