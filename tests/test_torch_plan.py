"""The port's plan–execute API (``SparseSpec``, ``plan``, ``MatmulPlan``,
``BoundPlan``, ``plan_for_operand``, ``Linear``), ``SpMMEngine`` on bound
plans and the serving launcher's ``--format bsr|dense``, against the JAX
package on the CPU.

Patterns, ``to_dense``, ``nnz`` and ``density`` are equal bit for bit;
products agree within ``1e-5 * max|C|`` (the JAX kernels run in Pallas
interpret mode, both sum in f32 in another order); served requests within
``1e-4`` of the float64 product, the launcher's own check.
"""
import dataclasses

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                   # noqa: E402

from repro.serve import engine as jeng                    # noqa: E402
from repro.sparse import api as japi                      # noqa: E402
from repro.sparse import pattern as jpat                  # noqa: E402
from repro_torch import convert, sparse                   # noqa: E402
from repro_torch.core.crs import CRS                      # noqa: E402
from repro_torch.core.incrs import InCRS                  # noqa: E402
from repro_torch.serve import engine as teng              # noqa: E402
from repro_torch.sparse import api as tapi                # noqa: E402
from repro_torch.sparse import linear as tlin             # noqa: E402

C_TOL = 1e-5
SERVE_TOL = 1e-4


def _close(got, want, tol=C_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    assert float(np.abs(got - want).max(initial=0.0)) <= tol * scale


def _weight(d_in=64, d_out=96, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(d_in, d_out)).astype(np.float32) * 0.02
    w[rng.random(w.shape) < 0.2] = 0.0
    return w


def _specs(mod, w):
    """(label, spec) pairs covering every selection of both formats."""
    mask = np.random.default_rng(1).random(w.shape) < 0.1
    return [("bsr-nonzeros", mod.SparseSpec("bsr", block=16)),
            ("bsr-density", mod.SparseSpec("bsr", block=16, density=0.3)),
            ("bsr-mask", mod.SparseSpec("bsr", block=16, mask=mask)),
            ("dense", mod.SparseSpec("dense")),
            ("dense-density", mod.SparseSpec("dense", density=0.4)),
            ("dense-mask", mod.SparseSpec("dense", mask=mask)),
            ("dense-2:4", mod.SparseSpec("dense", policy="2:4"))]


@pytest.mark.parametrize("i", range(7))
def test_linear_from_dense_matches_jax(i):
    w = _weight()
    label, jspec = _specs(japi, w)[i]
    tspec = _specs(tapi, w)[i][1]
    jl = japi.Linear.from_dense(w, jspec)
    tl = tapi.Linear.from_dense(w, tspec, device="cpu")
    assert tl.format == jl.format
    assert np.array_equal(tl.to_dense(), jl.to_dense()), label
    assert (tl.nnz, tl.density, tl.d_in, tl.d_out) == \
        (jl.nnz, jl.density, jl.d_in, jl.d_out)
    assert (tl.pattern is None) == (jl.pattern is None)
    if tl.pattern is not None:
        assert np.array_equal(tl.pattern.mask, jl.pattern.mask)
    assert [n for n, _ in tl.named_parameters()] == ["values"]
    x = np.random.default_rng(2).normal(size=(3, 5, 64)).astype(np.float32)
    _close(tl(torch.from_numpy(x)).detach().numpy(), np.asarray(jl(x)))
    bj, bt = jl.bound(), tl.bound()
    assert tuple(bt.shape) == tuple(bj.shape)
    b = np.random.default_rng(3).normal(size=(64, 40)).astype(np.float32)
    _close(bt(torch.from_numpy(b)).numpy(), np.asarray(bj(jnp.asarray(b))))


def test_linear_init_and_pattern_spec_match_jax():
    gen = torch.Generator().manual_seed(0)
    tl = tapi.Linear.init(32, 48, tapi.SparseSpec("bsr", block=16,
                                                  density=0.5),
                          generator=gen, device="cpu")
    w = tl.to_dense()
    assert tl.nnz == int(np.count_nonzero(tl.pattern.mask))
    jl = japi.Linear.from_dense(w, japi.SparseSpec(
        "bsr", block=16, pattern=jpat.SparsityPattern(tl.pattern.mask)))
    assert np.array_equal(np.asarray(jl.to_dense()), w)
    t2 = tapi.Linear.from_dense(w, tapi.SparseSpec("bsr", block=16,
                                                   pattern=tl.pattern),
                                device="cpu")
    assert t2.pattern is tl.pattern and t2.nnz == tl.nnz
    ragged = sparse.SparsityPattern(np.eye(32, 48, dtype=bool))
    with pytest.raises(ValueError, match="block-aligned"):
        tapi.Linear.from_dense(w, tapi.SparseSpec("bsr", block=16,
                                                  pattern=ragged),
                               device="cpu")
    with pytest.raises(ValueError, match="needs block"):
        tapi.Linear.from_dense(w, tapi.SparseSpec("bsr"), device="cpu")


@pytest.mark.parametrize("fmt,block", [("bsr", 16), ("bsr", 32),
                                       ("dense", None)])
def test_plan_for_operand_matches_jax(fmt, block):
    rng = np.random.default_rng(4)
    a = rng.normal(size=(96, 128)).astype(np.float32)
    a[rng.random(a.shape) < 0.9] = 0.0
    a[:32] = 0.0                                  # empty block-rows
    b = rng.normal(size=(128, 70)).astype(np.float32)
    jb = japi.plan_for_operand(a, japi.SparseSpec(fmt, block=block))
    tb = tapi.plan_for_operand(a, tapi.SparseSpec(fmt, block=block),
                               device="cpu")
    assert tuple(tb.shape) == tuple(jb.shape) == a.shape
    got = tb(torch.from_numpy(b))
    _close(got.numpy(), np.asarray(jb(jnp.asarray(b))))
    _close(got.numpy(), a.astype(np.float64) @ b)
    for a_in in (CRS.from_dense(a), InCRS.from_dense(a), torch.from_numpy(a)):
        again = tapi.plan_for_operand(a_in, tapi.SparseSpec(fmt, block=block),
                                      device="cpu")
        assert torch.equal(again(torch.from_numpy(b)), got)


def test_plan_and_matmul_plan_match_jax():
    w = _weight()
    ragged = np.random.default_rng(5).random(w.shape) < 0.05
    for mod in (japi, tapi):                      # plan needs whole tiles
        with pytest.raises(ValueError, match="block-aligned"):
            mod.plan(mod.SparseSpec("bsr", block=16, mask=ragged))
    mask = jpat.expand_block_mask(
        jpat.SparsityPattern(ragged).block_mask(16), 16)
    jp = japi.plan(japi.SparseSpec("bsr", block=16, mask=mask), (64, 8))
    tp = tapi.plan(tapi.SparseSpec("bsr", block=16, mask=mask), (64, 8))
    for f in ("row_of", "col_of", "vpos", "t_perm", "t_row_of", "t_col_of",
              "t_vpos"):
        assert getattr(tp.meta, f) == getattr(jp.meta, f), f
    assert tp.shape == jp.shape and np.array_equal(tp.pattern.mask,
                                                   jp.pattern.mask)
    vals = tp.pack(w)
    assert np.array_equal(vals, np.asarray(jp.pack(w)))
    b = np.random.default_rng(6).normal(size=(64, 9)).astype(np.float32)
    want = np.asarray(jp(jnp.asarray(vals), jnp.asarray(b)))
    _close(tp(torch.from_numpy(vals), torch.from_numpy(b)).numpy(), want)
    bound = tp.bind(vals, device="cpu")
    _close(bound(torch.from_numpy(b)).numpy(), want)
    dp = tapi.plan(tapi.SparseSpec("dense"))
    assert dp.meta is None and dp.shape is None
    a = w.T.copy()
    _close(dp.bind(a, device="cpu")(b).numpy(),
           np.asarray(japi.plan(japi.SparseSpec("dense")).bind(
               jnp.asarray(a))(jnp.asarray(b))))
    with pytest.raises(ValueError, match="concrete pattern"):
        tapi.plan(tapi.SparseSpec("bsr", block=16, density=0.3))
    with pytest.raises(ValueError, match="contract"):
        tapi.plan(tapi.SparseSpec("bsr", block=16, mask=mask), (65, 8))


def test_unported_formats_name_their_roadmap_items():
    """``crs`` (ported with the lifecycle slice) now plans and binds
    through plan and plan_for_operand, and refuses Linear.from_dense as
    JAX does; ``incrs`` (ported with the training slice) builds through
    plan, plan_for_operand and Linear.from_dense."""
    from repro_torch.core.crs import CRS as TCRS
    w = _weight()
    spec = tapi.SparseSpec("crs", mask=w != 0, rounds=32)
    bt = np.where(np.random.default_rng(8).random((7, 64)) < 0.2, 1.5,
                  0.0).astype(np.float32)
    p = tapi.plan(spec)
    assert p.shape == (96, 64) and p.meta.rounds == 32
    _close(p.bind(p.pack(w), device="cpu")(TCRS.from_dense(bt)).numpy(),
           w.T @ bt.T)
    _close(tapi.plan_for_operand(w.T, tapi.SparseSpec("crs"), device="cpu")(
        TCRS.from_dense(bt)).numpy(), w.T @ bt.T)
    with pytest.raises(ValueError, match="plan–execute only"):
        tapi.Linear.from_dense(w, spec, device="cpu")
    spec = tapi.SparseSpec("incrs", mask=w != 0, section=32, block=8)
    b = np.random.default_rng(9).normal(size=(64, 5)).astype(np.float32)
    lin = tapi.Linear.from_dense(w, spec, device="cpu")
    assert lin.format == "incrs" and lin.nnz == int((w != 0).sum())
    assert np.array_equal(lin.to_dense(), w)
    assert lin.spec.section == 32 and lin.spec.block == 8
    p = tapi.plan(spec, (64, 5))
    assert p.shape == (96, 64) and p.meta.section == 32
    _close(p.bind(p.pack(w), device="cpu")(b).numpy(), w.T @ b)
    _close(tapi.plan_for_operand(w.T, tapi.SparseSpec("incrs"),
                                 device="cpu")(b).numpy(), w.T @ b)
    _close(lin.bound()(b).numpy(), w.T @ b)
    with pytest.raises(ValueError, match="f32 stripe values"):
        tapi.Linear.from_dense(w, spec, dtype=torch.bfloat16, device="cpu")
    from repro_torch.launch.mesh import make_mesh      # ported: item 8
    with pytest.raises(ValueError, match="mesh sharding is the InCRS"):
        tapi.SparseSpec("bsr", block=16, mesh=make_mesh(2, "cpu"))
    sharded = tapi.Linear.from_dense(
        w, dataclasses.replace(spec, mesh=make_mesh(2, "cpu")))
    assert sharded.format == "incrs_sharded" and sharded.spec.sharded
    _close(sharded.bound()(b).numpy(), w.T @ b)
    with pytest.raises(ValueError, match="format must be"):
        tapi.SparseSpec("coo")
    with pytest.raises(ValueError, match="at most one"):
        tapi.SparseSpec("bsr", density=0.1, mask=w != 0)
    with pytest.raises(TypeError):
        tapi.SparseSpec(block=16)                  # the format is required
    assert tapi.SparseSpec("crs", rhs_format="crs").rounds == 128


def test_resolve_device_gives_cuda_its_index(monkeypatch):
    """A CUDA device named without an index equals the device of the
    tensors made on it, so an engine on "cuda" takes a plan bound on
    "cuda:0" (ROADMAP fault P2)."""
    from repro_torch.kernels import ops as tops
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tops.resolve_device("cuda") == torch.device("cuda", 0)
    assert tops.resolve_device(None) == torch.device("cuda", 0)
    assert tops.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert tops.resolve_device("cpu") == torch.device("cpu")


def test_bsr_backward_raises_instead_of_a_silent_no_grad():
    """The BSR backward gives real gradients (it once raised rather than
    give none): dW on the live blocks, dx through the transposed lists."""
    w = _weight()
    lin = tapi.Linear.from_dense(w, tapi.SparseSpec(
        "bsr", block=16, density=0.5), device="cpu")
    x = torch.randn(4, 64, requires_grad=True)
    y = lin(x)
    assert y.requires_grad
    y.sum().backward()
    live = lin.pattern.mask
    gw = lin.to_dense(lin.values.grad)
    ones = np.ones((4, w.shape[1]), np.float32)
    want = x.detach().numpy().T @ ones
    _close(gw[live], want[live])
    assert not gw[~live].any()
    _close(x.grad.numpy(), ones @ lin.to_dense().T)
    with torch.no_grad():                          # serving needs no grad
        assert not lin(x).requires_grad
    assert not lin.bound()(torch.randn(64, 3)).requires_grad


def test_bsr_backward_names_its_roadmap_item():
    """The BSR backward, once queue 1 item 2, runs: the gradients of a
    layer with an empty block-row equal those of its dense weight."""
    w = _weight()
    mask = np.array([[1, 0, 1, 1], [0, 0, 0, 0], [0, 1, 0, 0],
                     [1, 1, 1, 1], [0, 0, 0, 0], [0, 0, 1, 0]], bool)
    p = tlin._bsr_from_mask(w, mask, 16, device="cpu")
    lin = tapi.Linear(p)
    x = torch.randn(6, 64, requires_grad=True)
    dy = torch.randn(6, w.shape[1])
    lin(x).backward(dy)
    wd = torch.from_numpy(lin.to_dense()).requires_grad_()
    xd = x.detach().clone().requires_grad_()
    (xd @ wd).backward(dy)
    live = lin.pattern.mask
    _close(lin.to_dense(lin.values.grad)[live], wd.grad.numpy()[live])
    _close(x.grad.numpy(), xd.grad.numpy())
    assert lin.values.grad.shape == (p.meta.nnz, 16, 16)


@pytest.mark.parametrize("fmt", ["bsr", "dense"])
def test_linear_from_jax_computes_the_same(fmt):
    w = _weight(seed=7)
    spec = dict(block=16, density=0.4) if fmt == "bsr" else dict(density=0.4)
    jl = japi.Linear.from_dense(w, japi.SparseSpec(fmt, **spec))
    fields = {f.name: (list(v) if isinstance(v, tuple) else v)
              for f in dataclasses.fields(jl.meta)
              for v in [getattr(jl.meta, f.name)] if f.name != "pattern"}
    fields["mask"] = jl.pattern.mask
    fields["version"] = jl.pattern.version
    tl = convert.linear_from_jax(np.asarray(jl.values), fields, fmt,
                                 device="cpu")
    assert np.array_equal(tl.to_dense(), np.asarray(jl.to_dense()))
    assert tl.nnz == jl.nnz and tl.format == jl.format
    b = np.random.default_rng(8).normal(size=(64, 12)).astype(np.float32)
    _close(tl.bound()(b).numpy(), np.asarray(jl.bound()(jnp.asarray(b))))
    with pytest.raises(ValueError, match="fmt"):
        convert.linear_from_jax(np.asarray(jl.values), fields, "crs")


def _trace(k, cap, seed=1):
    rng = np.random.default_rng(seed)
    bc = cap // 2
    widths = [(bc, bc // 2, bc // 4, bc + bc // 2)[r % 4] for r in range(8)]
    widths.append(cap * 2 + 40)                   # split into parts
    return [rng.normal(size=(k, w)).astype(np.float32) for w in widths]


@pytest.mark.parametrize("fmt", ["bsr", "dense"])
def test_engine_on_a_bound_plan_matches_jax_engine(fmt):
    rng = np.random.default_rng(9)
    a = rng.normal(size=(64, 96)).astype(np.float32)
    a[rng.random(a.shape) < 0.85] = 0.0
    block = 16 if fmt == "bsr" else None
    je = jeng.SpMMEngine(japi.plan_for_operand(a, japi.SparseSpec(
        fmt, block=block)), max_wave_cols=128)
    te = teng.SpMMEngine(tapi.plan_for_operand(a, tapi.SparseSpec(
        fmt, block=block), device="cpu"), max_wave_cols=128)
    assert te.device.type == "cpu" and te.pattern_version == \
        je.pattern_version
    panels = _trace(96, 128)
    for eng, cls in ((je, jeng.SpMMRequest), (te, teng.SpMMRequest)):
        for i, p in enumerate(panels):
            eng.submit(cls(i, p))
        eng.run()
    jout = {r.rid: r.out for r in je.finished}
    assert sorted(r.rid for r in te.finished) == sorted(jout)
    for r in te.finished:
        _close(r.out, jout[r.rid])
        _close(r.out, a.astype(np.float64) @ r.b, tol=SERVE_TOL)
    for key in ("split_requests", "split_parts", "requests", "cols"):
        assert te.stats[key] == je.stats[key], key


def test_engine_swaps_across_formats_and_rejects_cleanly():
    rng = np.random.default_rng(10)
    a = rng.normal(size=(64, 96)).astype(np.float32)
    a[rng.random(a.shape) < 0.8] = 0.0
    bsr = tapi.plan_for_operand(a, tapi.SparseSpec("bsr", block=32),
                                device="cpu")
    eng = teng.SpMMEngine(bsr, max_wave_cols=128)
    assert eng.pattern_version == 0
    b = rng.normal(size=(96, 40)).astype(np.float32)
    half = np.where(jpat.magnitude_mask(a, 0.1), a, 0.0).astype(np.float32)
    lin = tapi.Linear.from_dense(half.T, tapi.SparseSpec("dense"),
                                 device="cpu")
    for new, want in ((tapi.plan_for_operand(a, tapi.SparseSpec("dense"),
                                             device="cpu"), a),
                      (InCRS.from_dense(half), half),
                      (lin, half),
                      (bsr, a)):
        eng.swap_pattern(new)
        eng.submit(teng.SpMMRequest(0, b))
        out = eng.run()[-1].out
        _close(out, want.astype(np.float64) @ b, tol=SERVE_TOL)
    assert eng.stats["pattern_swaps"] == 4
    before = (eng.a, eng.prep, eng.pattern_version)
    wrong = tapi.plan_for_operand(a[:32], tapi.SparseSpec("dense"),
                                  device="cpu")
    with pytest.raises(ValueError, match="swap_pattern"):
        eng.swap_pattern(wrong)
    with pytest.raises(ValueError, match="SparseSpec alone"):
        eng.swap_pattern(tapi.SparseSpec("bsr", block=32))
    with pytest.raises(ValueError, match="bind values"):
        eng.swap_pattern(bsr.plan)
    assert (eng.a, eng.prep, eng.pattern_version) == before
    assert eng.stats["pattern_swaps"] == 4
    with pytest.raises(ValueError, match="SparseSpec alone"):
        teng.SpMMEngine(tapi.SparseSpec("dense"), device="cpu")
    with pytest.raises(ValueError, match="bind values"):
        teng.SpMMEngine(bsr.plan, device="cpu")


def test_engine_keeps_a_wave_whose_launch_raised():
    """A wave whose kernel call raises stays staged: no request is lost,
    and the next run serves it."""
    rng = np.random.default_rng(11)
    a = rng.normal(size=(64, 96)).astype(np.float32)
    bound = tapi.plan_for_operand(a, tapi.SparseSpec("dense"), device="cpu")
    eng = teng.SpMMEngine(bound, max_wave_cols=128)

    def refuse(b):
        raise RuntimeError("launch refused")

    eng.prep = refuse
    panels = [rng.normal(size=(96, w)).astype(np.float32) for w in (40, 24)]
    for i, p in enumerate(panels):
        eng.submit(teng.SpMMRequest(i, p))
    with pytest.raises(RuntimeError, match="launch refused"):
        eng.run()
    assert eng._staged is not None and eng.stats["requests"] == 0
    eng.prep = bound
    done = {r.rid: r for r in eng.run()}
    assert sorted(done) == [0, 1]
    for i, p in enumerate(panels):
        _close(done[i].out, a.astype(np.float64) @ p, tol=SERVE_TOL)


@pytest.mark.parametrize("argv", [
    ["--format", "bsr", "--spmm-block", "32"],
    ["--format", "dense"],
    ["--format", "bsr", "--spmm-swap"],
    ["--format", "dense", "--spmm-swap"],
    ["--format", "incrs", "--spmm-swap"],
    ["--format", "bsr", "--workload", "incrs-docword", "--scale", "0.06",
     "--spmm-block", "6"],
], ids=lambda a: "_".join(x.strip("-") for x in a))
def test_launcher_serves_every_format_on_cpu(capsys, argv):
    from repro_torch.launch import serve
    rc = serve.main(["--spmm", "--device", "cpu", "--n-requests", "3",
                     *argv])
    assert rc == 0
    out = capsys.readouterr().out
    assert "served 3 requests" in out and f"format={argv[1]}" in out
    if "--spmm-swap" in argv:
        assert "swaps=1" in out and "served 3 more" in out


def test_launcher_refuses_a_block_that_does_not_divide():
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="must divide"):
        serve.main(["--spmm", "--device", "cpu", "--format", "bsr",
                    "--workload", "incrs-docword", "--scale", "0.06"])


@pytest.mark.parametrize("fmt", ["bsr", "dense"])
def test_engine_on_a_bf16_plan_matches_jax_linear(fmt):
    """A bf16 plan (``Linear.from_dense(..., dtype=bfloat16)``) served by
    the engine with bf16 requests (CPU tensors), held against the JAX
    ``Linear`` of the same dtype on the same numpy inputs: ``1e-2 *
    max|C|`` (C is rounded to bf16 on both sides, the sums are f32 in
    different orders). The engine keeps the wave's type, as JAX's does."""
    w = _weight(64, 96, seed=12)
    block = 16 if fmt == "bsr" else None
    jb = japi.Linear.from_dense(w, japi.SparseSpec(fmt, block=block),
                                dtype=jnp.bfloat16).bound()
    tlin = tapi.Linear.from_dense(w, tapi.SparseSpec(fmt, block=block),
                                  dtype=torch.bfloat16, device="cpu")
    assert tlin.values.dtype == torch.bfloat16
    np.testing.assert_array_equal(tlin.to_dense(), np.asarray(
        japi.Linear.from_dense(w, japi.SparseSpec(fmt, block=block),
                               dtype=jnp.bfloat16).to_dense(), np.float32))
    eng = teng.SpMMEngine(tlin.bound(), max_wave_cols=128)
    rng = np.random.default_rng(13)
    panels = [rng.normal(size=(64, width)).astype(np.float32)
              for width in (40, 24, 200)]
    for i, p in enumerate(panels):
        eng.submit(teng.SpMMRequest(i, torch.from_numpy(p).bfloat16()))
    done = {r.rid: r for r in eng.run()}
    for i, p in enumerate(panels):
        want = np.asarray(jb(jnp.asarray(p, jnp.bfloat16)), np.float32)
        got = done[i].out
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        _close(got.float().numpy(), want, tol=1e-2)
