"""The port's training path against the JAX package, on the CPU.

Trainable InCRS and BSR layers (``sparse.linear``), AdamW
(``train.optimizer``), the training example and the conversion of a JAX
layer and optimizer state. On the CPU the port runs its kernels' plain
versions; the kernels themselves are held on the card by
``test_torch_cuda_train.py`` (no JAX) and ``chip_smoke.py`` phase
``train``.

The JAX InCRS ``Linear`` cannot be differentiated on this tree (ROADMAP
fault C1: its ``auto`` variant reaches the pipelined Pallas kernel, which
calls the removed ``pl.load``), so the InCRS backward is held against the
JAX pieces it is made of, run with ``variant="expand"``: the forward
``ops.spmm`` over the stripes, dx's ``ops.spmm`` over the transposed
stripes with values gathered through ``t_gather``, and ``_stripe_dw``.
The BSR backward is held against ``jax.grad`` of ``_bsr_apply``.

Tolerances: packing bit for bit; products and gradients ``1e-5 *
max|ref|`` (both sum in f32, in another order); AdamW parameters ``1e-6``
relative, its int8 payloads and scales equal.
"""
import dataclasses

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401

torch = pytest.importorskip("torch")

import jax                                                # noqa: E402
import jax.numpy as jnp                                   # noqa: E402

from repro.core.crs import CRS as JCRS                    # noqa: E402
from repro.kernels import ops as jops                     # noqa: E402
from repro.sparse import api as japi                      # noqa: E402
from repro.sparse import linear as jlin                   # noqa: E402
from repro.train import optimizer as jopt                 # noqa: E402
from repro_torch import convert                           # noqa: E402
from repro_torch.core.crs import CRS as TCRS              # noqa: E402
from repro_torch.examples import train_unstructured as ex  # noqa: E402
from repro_torch.sparse import api as tapi                # noqa: E402
from repro_torch.sparse import linear as tlin             # noqa: E402
from repro_torch.train import optimizer as topt           # noqa: E402

TOL = 1e-5
CPU = torch.device("cpu")
# the example's defaults: 128 -> 256 -> 64, T = 64, section 64, block 8
D_IN, D_HID, D_OUT, T, SECTION, BLOCK, BSR_BLOCK = 128, 256, 64, 64, 64, 8, 32


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, (err, scale)


def _normal(shape, seed, scale=1.0):
    return np.asarray(np.random.default_rng(seed).normal(size=shape) * scale,
                      np.float32)


def _keeps_zeros_mask(w, seed):
    """A random element mask of ``w`` that keeps some slots whose value
    is exactly 0.0 (a trained weight that crossed zero stays live)."""
    rng = np.random.default_rng(seed)
    mask = rng.random(w.shape) < 0.15
    w[mask & (rng.random(w.shape) < 0.2)] = 0.0
    return mask


# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(40, 70), (1, 5), (33, 1), (0, 4)])
def test_crs_from_mask_is_the_jax_one_bit_for_bit(shape):
    w = _normal(shape, 1)
    mask = _keeps_zeros_mask(w, 2)
    t, j = TCRS.from_mask(w, mask), JCRS.from_mask(w, mask)
    for f in ("values", "col_idx", "row_ptr"):
        x, y = getattr(t, f), getattr(j, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert t.shape == j.shape and t.nnz == int(mask.sum())
    nz = w != 0
    assert np.array_equal(TCRS.from_mask(w, nz).values,
                          TCRS.from_dense(w).values)
    with pytest.raises(ValueError, match="mask shape"):
        TCRS.from_mask(w, mask.T if shape[0] != shape[1] else mask[:1])


def _pack_pair(how, d_in=D_IN, d_out=D_HID, seed=3):
    w = _normal((d_in, d_out), seed, 0.2)
    if how == "density":
        kw = dict(density=0.1)
    else:
        kw = dict(mask=_keeps_zeros_mask(w, seed + 1))
    tp = tlin._incrs_from_dense(w, section=SECTION, block=BLOCK, device=CPU,
                                **kw)
    jp = jlin._incrs_from_dense(w, section=SECTION, block=BLOCK, **kw)
    return w, tp, jp


@pytest.mark.parametrize("how", ["density", "mask_with_zeros"])
def test_pack_incrs_is_the_jax_packer_bit_for_bit(how):
    w, tp, jp = _pack_pair(how)
    for f in ("fwd_idx", "bwd_idx", "t_gather"):
        x = getattr(tp.meta, f).numpy()
        y = np.asarray(getattr(jp.meta, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert tp.values.dtype == torch.float32
    assert np.array_equal(tp.values.numpy(), np.asarray(jp.values))
    assert tp.meta.nnz == jp.meta.nnz == tp.pattern.nnz
    assert (tp.meta.d_in, tp.meta.d_out, tp.meta.section, tp.meta.block) == \
        (jp.meta.d_in, jp.meta.d_out, jp.meta.section, jp.meta.block)
    assert np.array_equal(tp.pattern.mask, jp.pattern.mask)
    assert np.array_equal(tlin.incrs_to_dense_weight(tp),
                          jlin.incrs_to_dense_weight(jp))
    assert np.array_equal(tlin._incrs_pack_values(tp.meta, w),
                          np.asarray(jlin._incrs_pack_values(jp.meta, w)))
    if how != "density":             # live slots at 0.0 stay in the pattern
        assert tp.meta.nnz == int(tp.pattern.mask.sum())
    else:                            # the family's init draws as Linear's
        kw = dict(section=SECTION, block=BLOCK, device=CPU)
        got = tlin._incrs_init(torch.Generator().manual_seed(4), D_IN, D_HID,
                               0.1, scale=0.2, **kw)
        want = tapi.Linear.init(D_IN, D_HID, tapi.SparseSpec(
            "incrs", density=0.1, section=SECTION, block=BLOCK),
            generator=torch.Generator().manual_seed(4), scale=0.2,
            device=CPU)
        assert torch.equal(got.values, want.values.detach())


def _jax_composed(jp, x, dy):
    """Forward, dx and dW of the JAX InCRS layer from its pieces."""
    m = jp.meta
    prep = jops.PreparedOperand(m.fwd_idx, jp.values, (m.d_out, m.d_in),
                                m.section)
    y = jops.spmm(prep, jnp.asarray(x).T, variant="expand").T
    flat = jnp.concatenate([jp.values.reshape(-1),
                            jnp.zeros((1,), jp.values.dtype)])
    tprep = jops.PreparedOperand(m.bwd_idx,
                                 flat[m.t_gather].reshape(m.bwd_idx.shape),
                                 (m.d_in, m.d_out), m.section)
    dx = jops.spmm(tprep, jnp.asarray(dy).T, variant="expand").T
    dw = jlin._stripe_dw(m.fwd_idx, m.section, jnp.asarray(x),
                         jnp.asarray(dy))
    return np.asarray(y), np.asarray(dx), np.asarray(dw)


@pytest.mark.parametrize("how", ["density", "mask_with_zeros"])
@pytest.mark.parametrize("t", [T, 37])
def test_incrs_forward_dx_dw_match_the_jax_composition(how, t):
    _, tp, jp = _pack_pair(how)
    x, dy = _normal((t, D_IN), 5), _normal((t, D_HID), 6)
    jy, jdx, jdw = _jax_composed(jp, x, dy)
    lin = tapi.Linear(tp)
    xt = torch.from_numpy(x).requires_grad_()
    y = lin(xt)
    y.backward(torch.from_numpy(dy))
    _close(y.detach().numpy(), jy)
    _close(xt.grad.numpy(), jdx)
    _close(lin.values.grad.numpy(), jdw)


def test_incrs_pad_slots_get_exactly_zero():
    _, tp, _ = _pack_pair("density")
    lin = tapi.Linear(tp)
    before = tp.values.clone()
    pad = tp.meta.fwd_idx < 0
    assert bool(pad.any()) and bool((lin.values.detach()[pad] == 0).all())
    x = torch.from_numpy(_normal((T, D_IN), 7))
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    params = dict(lin.named_parameters())
    state = topt.adamw_init(cfg, params)
    for step in range(3):
        loss = (lin(x) ** 2).mean()
        (g,) = torch.autograd.grad(loss, [lin.values])
        assert g.shape == lin.values.shape
        assert bool((g[pad] == 0.0).all()), step      # exactly +0.0 or -0.0
        assert float(g[~pad].abs().max()) > 0
        _, state, _ = topt.adamw_update(cfg, {"values": g}, state, params)
    assert bool((lin.values.detach()[pad] == 0.0).all())
    assert not torch.equal(lin.values.detach(), before)


def test_incrs_gradcheck_in_float64():
    """The function is linear in each input, so a large step is exact;
    the plain versions sum in f32, which sets the tolerances."""
    w = _normal((24, 40), 8)
    p = tlin._incrs_from_dense(w, density=0.3, section=16, block=4,
                               device=CPU)
    vals = p.values.double().requires_grad_()
    x = torch.from_numpy(_normal((5, 24), 9)).double().requires_grad_()

    def fn(v, xx):
        return tlin._InCRSMM.apply(v, xx, p.meta)
    assert torch.autograd.gradcheck(fn, (vals, x), eps=0.5, atol=1e-4,
                                    rtol=1e-4, nondet_tol=0.0)
    bsr = tlin._bsr_from_mask(_normal((32, 48), 10),
                              np.array([[1, 0], [0, 0], [1, 1]], bool), 16,
                              device=CPU)
    bv = bsr.values.double().requires_grad_()
    bx = torch.from_numpy(_normal((3, 32), 11)).double().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda v, xx: tlin._SparseMM.apply(v, xx, bsr.meta), (bv, bx),
        eps=0.5, atol=1e-4, rtol=1e-4)


# ----------------------------------------------------------------------
BSR_CASES = [  # (label, d_in, d_out, block, T, empty W^T block-rows)
    ("full_rows", D_IN, D_HID, BSR_BLOCK, T, ()),
    ("empty_block_row", D_IN, D_HID, BSR_BLOCK, T, (2, 5)),
    ("t_not_128", D_HID, D_OUT, BSR_BLOCK, 200, (1,)),
]


@pytest.mark.parametrize("case", BSR_CASES, ids=lambda c: c[0])
def test_bsr_gradients_match_jax_grad(case):
    _, d_in, d_out, blk, t, empty = case
    rng = np.random.default_rng(12)
    w = _normal((d_in, d_out), 13, 0.2)
    mask = rng.random((d_out // blk, d_in // blk)) < 0.4
    mask[np.arange(mask.shape[0]), np.arange(mask.shape[0]) %
         mask.shape[1]] = True
    mask[list(empty)] = False
    tp = tlin._bsr_from_mask(w, mask, blk, device=CPU)
    jp = jlin._bsr_from_mask(w, mask, blk)
    assert len(tp.meta.col_of) == tp.meta.nnz + len(empty)
    x, dy = _normal((t, d_in), 14), _normal((t, d_out), 15)

    def jloss(vals, xx):
        return jnp.sum(jlin._bsr_apply(jlin.SparseLinearParams(vals, jp.meta),
                                       xx) * jnp.asarray(dy))
    jgv, jgx = jax.grad(jloss, argnums=(0, 1))(jp.values, jnp.asarray(x))
    lin = tapi.Linear(tp)
    xt = torch.from_numpy(x).requires_grad_()
    (lin(xt) * torch.from_numpy(dy)).sum().backward()
    _close(lin.values.grad.numpy(), np.asarray(jgv))
    _close(xt.grad.numpy(), np.asarray(jgx))
    # zero tiles are no parameter: the empty block-rows get no gradient
    assert lin.values.grad.shape == (tp.meta.nnz, blk, blk)
    gd = lin.to_dense(lin.values.grad)
    for r in empty:
        assert not gd[:, r * blk:(r + 1) * blk].any()


def test_bsr_dx_only_when_the_input_needs_it():
    tp = tlin._bsr_from_mask(_normal((64, 96), 16), np.ones((3, 2), bool),
                             32, device=CPU)
    lin = tapi.Linear(tp)
    x = torch.from_numpy(_normal((9, 64), 17))
    lin(x).sum().backward()
    assert lin.values.grad is not None and not x.requires_grad


# ----------------------------------------------------------------------
def _adamw_case():
    """Parameters as the JAX tree (nested dicts) and the port's dotted
    names: blockwise (last dim 256 / 512) and per-row scales, a scalar,
    and the no-decay names."""
    shapes = {"w": (3, 512), "b": (300,), "blocks.0.norm_mlp": (256,),
              "blocks.0.ffn.mask_w_up": (4, 5), "blocks.0.ffn.w_up": (2, 256),
              "norm_final": (7,), "scale": ()}
    flat = {k: _normal(s, 20 + i, 0.5) for i, (k, s) in
            enumerate(shapes.items())}
    tree = {}
    for k, v in flat.items():
        node = tree
        *parents, leaf = k.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = v
    return flat, tree


def _flatten(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) != {"q", "s"}:
            out.update(_flatten(v, f"{pre}{k}."))
        else:
            out[f"{pre}{k}"] = v
    return out


# (quantize, gradient scale): at 0.3 the global norm is ~15 and clipping
# scales every gradient by 1 / norm, which the two packages sum in another
# order; at 0.003 it is ~0.15 and the clip factor is exactly 1.
ADAMW_CASES = {"f32": (False, 0.3), "int8": (True, 0.003),
               "int8_clipped": (True, 0.3)}


@pytest.mark.parametrize("case", ADAMW_CASES)
def test_adamw_matches_jax_update(case):
    """Five updates: parameters within 1e-6 relative, the metrics too; the
    int8 payloads and scales equal, and where the clip factor comes from
    the two packages' sums (``int8_clipped``), payloads within one step
    of the int8 grid and scales within 1e-6 relative."""
    quantize, gscale = ADAMW_CASES[case]
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, warmup_steps=2, total_steps=6,
                  quantize=quantize)
    jcfg, tcfg = jopt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
    flat, tree = _adamw_case()
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
    jstate = jopt.adamw_init(jcfg, jparams)
    tstate = topt.adamw_init(tcfg, tparams)
    for step in range(5):
        gflat = {k: _normal(v.shape, 100 + 10 * step + i, gscale)
                 for i, (k, v) in enumerate(flat.items())}
        gtree = _unflatten_like(tree, gflat)
        jparams, jstate, jm = jopt.adamw_update(
            jcfg, jax.tree.map(jnp.asarray, gtree), jstate, jparams)
        _, tstate, tm = topt.adamw_update(
            tcfg, {k: torch.from_numpy(g) for k, g in gflat.items()},
            tstate, tparams)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6, err_msg=k)
        assert int(tstate["count"]) == int(jstate["count"]) == step + 1
        jflat = _flatten(jax.tree.map(np.asarray, jparams))
        for k, p in tparams.items():
            _close(p.numpy(), jflat[k], tol=1e-6)
        for mom in ("m", "v"):
            jmom = _flatten(jax.tree.map(np.asarray, jstate[mom]))
            for k, t in tstate[mom].items():
                if quantize:
                    for part in ("q", "s"):
                        x, y = t[part].numpy(), jmom[k][part]
                        assert x.dtype == y.dtype and x.shape == y.shape
                        if case == "int8":
                            assert np.array_equal(x, y), (step, mom, k, part)
                        elif part == "q":
                            assert np.abs(x.astype(int) - y).max() <= 1
                        else:
                            _close(x, y, tol=1e-6)
                else:
                    _close(t.numpy(), jmom[k], tol=1e-6)


def test_adamw_takes_no_decay_on_mask_and_norm_names():
    """With zero gradients and zero moments only weight decay moves a
    parameter: names with a part starting ``mask_`` or ``norm`` stay."""
    flat, _ = _adamw_case()
    cfg = topt.AdamWConfig(lr=1e-2, weight_decay=0.1, warmup_steps=0)
    params = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
    state = topt.adamw_init(cfg, params)
    topt.adamw_update(cfg, {k: torch.zeros_like(p)
                            for k, p in params.items()}, state, params)
    kept = {"blocks.0.norm_mlp", "blocks.0.ffn.mask_w_up", "norm_final"}
    for k, p in params.items():
        moved = not np.array_equal(p.numpy(), flat[k])
        assert moved == (k not in kept), k
        if moved:
            _close(p.numpy(), flat[k] * (1 - 1e-2 * 0.1), tol=1e-6)


def _unflatten_like(tree, flat, pre=""):
    return {k: (_unflatten_like(v, flat, f"{pre}{k}.")
                if isinstance(v, dict) else flat[f"{pre}{k}"])
            for k, v in tree.items()}


@pytest.mark.parametrize("step", [0, 1, 2, 50, 99, 100, 101, 5000, 10_000,
                                  20_000])
def test_lr_schedule_matches_jax(step):
    cfg = dict(lr=3e-4, warmup_steps=100, total_steps=10_000)
    np.testing.assert_allclose(
        float(topt.lr_at(topt.AdamWConfig(**cfg), step)),
        float(jopt.lr_at(jopt.AdamWConfig(**cfg), step)), rtol=1e-6)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["incrs", "bsr"])
def test_example_reduces_the_loss(fmt, capsys):
    out = ex.main(["--format", fmt, "--device", "cpu"])
    assert out["losses"][-1] < out["losses"][0]
    assert len(out["losses"]) == 40
    assert all(e <= ex.GRAD_TOL for e in out["grad_err"].values())
    assert out["served_err"] <= ex.SERVE_TOL and out["waves"] >= 1
    assert "round trip OK" in capsys.readouterr().out


def test_incrs_trajectory_equals_a_dense_masked_student():
    """Five AdamW steps of the InCRS student and of a dense student whose
    weights are masked to the same pattern: the same losses and weights."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(T, D_IN)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(T, D_OUT)).astype(np.float32))
    w1, w2 = _normal((D_IN, D_HID), 30, 0.2), _normal((D_HID, D_OUT), 31, 0.2)
    spec = tapi.SparseSpec("incrs", density=0.1, section=SECTION,
                           block=BLOCK)
    sparse = torch.nn.ModuleDict({
        "l1": tapi.Linear.from_dense(w1, spec, device=CPU),
        "l2": tapi.Linear.from_dense(w2, spec, device=CPU)})
    dense = torch.nn.ModuleDict({
        k: tapi.Linear.from_dense(w, tapi.SparseSpec(
            "dense", mask=sparse[k].pattern.mask), device=CPU)
        for k, w in (("l1", w1), ("l2", w2))})
    cfg = topt.AdamWConfig(lr=3e-3, weight_decay=0.0, warmup_steps=2,
                           total_steps=5)
    runs = {}
    for name, model in (("sparse", sparse), ("dense", dense)):
        state = topt.adamw_init(cfg, dict(model.named_parameters()))
        losses = []
        for _ in range(5):
            loss, state, _ = ex.train_step(cfg, model, state, x, y)
            losses.append(float(loss))
        runs[name] = (losses, {k: m.to_dense() for k, m in model.items()})
    _close(runs["sparse"][0], runs["dense"][0])
    for k in ("l1", "l2"):
        _close(runs["sparse"][1][k], runs["dense"][1][k])
        assert not np.array_equal(runs["sparse"][1][k],
                                  np.where(sparse[k].pattern.mask,
                                           (w1, w2)[k == "l2"], 0))


def _jax_incrs_step(jcfg, jl, jstate, x, y):
    """One JAX training step of the 2-layer student, its gradients
    composed from the JAX pieces (``_jax_composed``), as C1 stops
    ``jax.grad`` of the JAX InCRS layer."""
    m1 = jl["l1"].meta

    def fwd(p, xx):
        prep = jops.PreparedOperand(p.meta.fwd_idx, p.values,
                                    (p.meta.d_out, p.meta.d_in),
                                    p.meta.section)
        return jops.spmm(prep, xx.T, variant="expand").T
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    h = jnp.tanh(fwd(jl["l1"].inner, xj))
    out = fwd(jl["l2"].inner, h)
    dout = 2.0 * (out - yj) / out.size
    _, dh, dw2 = _jax_composed(jl["l2"].inner, np.asarray(h),
                               np.asarray(dout))
    dpre = jnp.asarray(dh) * (1 - h * h)
    dw1 = jlin._stripe_dw(m1.fwd_idx, m1.section, xj, dpre)
    params = {"l1": jl["l1"].inner.values, "l2": jl["l2"].inner.values}
    grads = {"l1": dw1, "l2": jnp.asarray(dw2)}
    params, jstate, _ = jopt.adamw_update(jcfg, grads, jstate, params)
    for k in ("l1", "l2"):
        jl[k] = japi.Linear(jlin.InCRSLinearParams(params[k], jl[k].meta))
    return jstate


def test_linear_and_adamw_state_from_jax_take_the_jax_next_step():
    rng = np.random.default_rng(40)
    x = rng.normal(size=(T, D_IN)).astype(np.float32)
    y = rng.normal(size=(T, D_OUT)).astype(np.float32)
    spec = japi.SparseSpec("incrs", density=0.1, section=SECTION,
                           block=BLOCK)
    jl = {"l1": japi.Linear.from_dense(_normal((D_IN, D_HID), 41, 0.2), spec),
          "l2": japi.Linear.from_dense(_normal((D_HID, D_OUT), 42, 0.2),
                                       spec)}
    kw = dict(lr=3e-3, weight_decay=0.01, warmup_steps=1, total_steps=4)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jstate = jopt.adamw_init(jcfg, {k: v.inner.values for k, v in jl.items()})
    for _ in range(2):
        jstate = _jax_incrs_step(jcfg, jl, jstate, x, y)
    model = torch.nn.ModuleDict()
    for k, l in jl.items():
        fields = {f.name: getattr(l.meta, f.name)
                  for f in dataclasses.fields(l.meta) if f.name != "pattern"}
        fields = {f: (np.asarray(v) if hasattr(v, "shape") else v)
                  for f, v in fields.items()}
        fields["mask"] = l.pattern.mask
        fields["version"] = l.pattern.version
        model[k] = convert.linear_from_jax(np.asarray(l.values), fields,
                                           "incrs", device=CPU)
        assert np.array_equal(model[k].to_dense(), jlin.incrs_to_dense_weight(
            l.inner))
        assert model[k].format == "incrs" and model[k].nnz == l.nnz
    tstate = convert.adamw_state_from_jax(
        {"m": {f"{k}.values": np.asarray(v) for k, v in jstate["m"].items()},
         "v": {f"{k}.values": np.asarray(v) for k, v in jstate["v"].items()},
         "count": np.asarray(jstate["count"])}, device=CPU)
    jstate = _jax_incrs_step(jcfg, jl, jstate, x, y)
    ex.train_step(tcfg, model, tstate, torch.from_numpy(x),
                  torch.from_numpy(y))
    for k in ("l1", "l2"):
        _close(model[k].values.detach().numpy(), np.asarray(jl[k].values),
               tol=TOL)
    with pytest.raises(ValueError, match="do not fit"):
        convert.linear_from_jax(np.zeros((3, 3, 3), np.float32), fields,
                                "incrs", device=CPU)
    with pytest.raises(ValueError, match="quantized moment"):
        convert.adamw_state_from_jax({"m": {"a": {"q": 0}}, "v": {"a": 0},
                                      "count": 0}, device=CPU)
