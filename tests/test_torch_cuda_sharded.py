"""The row-sharded InCRS path on the card: each shard's launch of the
hand-written InCRS kernels against the single-device kernel's rows and
the plain version, the sharded layer's gradients, the sharded engine and
its swap, and the launcher.

This file imports nothing of JAX, so it runs on a machine that has the card
and no JAX: ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_cuda_sharded.py`` (the shared conftest imports JAX). On a
machine without CUDA every test skips. The meshes name one card 8 times
(``make_mesh(8, "cuda:0")``); the multi-card case runs only where more
than one card is visible.

Tolerances: each shard's rows bitwise equal to the single-device kernel's
(one order sums every element the same way at every geometry); kernel
against plain version ``1e-5 * max|C|``; against float64 ``1e-4 *
max|C|``; dx (a sum over shards) ``1e-4 * max|dx|``.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.incrs import InCRS                  # noqa: E402
from repro_torch.kernels import incrs_spmm as K           # noqa: E402
from repro_torch.kernels import ops                       # noqa: E402
from repro_torch.launch.mesh import make_mesh             # noqa: E402
from repro_torch.serve import engine as E                 # noqa: E402
from repro_torch.sparse import api                        # noqa: E402
from repro_torch.sparse import linear as lin              # noqa: E402
from repro_torch.sparse import pattern as spat            # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_TOL = 1e-5
F64_TOL = 1e-4
ORDERS = ("expand", "reuse", "pipelined")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _operand(m=2000, k=1536, d=0.05, seed=0):
    rng = np.random.default_rng(seed)
    a = np.where(rng.random((m, k)) < d, rng.normal(size=(m, k)),
                 0.0).astype(np.float32)
    return a, InCRS.from_dense(a, section=256, block=32)


def _close(got, want, tol):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got.double() - want.double()).abs().max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ORDERS)
def test_each_shard_is_the_single_device_rows(cuda, variant):
    a, inc = _operand()
    mesh = make_mesh(8, "cuda:0")
    prep = ops.prepare_incrs_sharded(inc, mesh)
    single = ops.prepare_incrs(inc, device=cuda)
    b = torch.randn(a.shape[1], 384, device=cuda)
    want = ops.spmm(single, b, variant=variant)
    K.reset_launches()
    got = ops.spmm(prep, b, variant=variant)
    assert K.LAUNCHES[K.ORDERS[variant]] == 8
    assert torch.equal(got, want)
    _close(got, torch.from_numpy(a).double().to(cuda) @ b.double(), F64_TOL)
    kp = prep.n_sections * prep.section
    bp = torch.nn.functional.pad(b, (0, 0, 0, kp - b.shape[0]))
    for s in range(prep.n_shards):
        lo, hi = prep.row_range(s)
        out = ops._INCRS_KERNELS[variant](prep.idx[s], prep.val[s], bp,
                                          section=prep.section, bn=384)
        ref = K.plain(K.ORDERS[variant], prep.idx[s], prep.val[s], bp,
                      section=prep.section, bn=384)
        _close(out, ref, KERNEL_TOL)
        assert torch.equal(out[:hi - lo], want[lo:hi])


@pytest.mark.gpu
def test_sharded_layer_gradients_on_card(cuda):
    """Forward and dW bitwise equal to the single-device layer; dx (the
    sum over shards) within bound, bitwise or not (printed)."""
    rng = np.random.default_rng(1)
    w = np.where(rng.random((512, 2048)) < 0.1, rng.normal(size=(512, 2048)),
                 0.0).astype(np.float32)
    spec = api.SparseSpec("incrs", section=256, block=32)
    l1 = api.Linear.from_dense(w, spec, device=cuda)
    l8 = l1.shard(make_mesh(8, "cuda:0"))
    x = torch.randn(300, 512, device=cuda)
    grads = []
    for layer in (l1, l8):
        xr = x.clone().requires_grad_(True)
        y = layer(xr)
        (y ** 2).sum().backward()
        vals = layer.values
        g = vals.grad if isinstance(vals, torch.Tensor) else \
            [v.grad for v in vals]
        grads.append((y.detach(), layer.to_dense(g), xr.grad))
    (y1, w1, x1), (y8, w8, x8) = grads
    assert torch.equal(y1, y8)
    np.testing.assert_array_equal(w1, w8)
    _close(x8, x1, F64_TOL)
    print("dx bitwise:", bool(torch.equal(x1, x8)))


@pytest.mark.gpu
def test_sharded_engine_and_swap_on_card(cuda):
    a, inc = _operand(seed=2)
    mesh = make_mesh(8, "cuda:0")
    rng = np.random.default_rng(3)
    panels = [rng.normal(size=(a.shape[1], w)).astype(np.float32)
              for w in (64, 384, 128, 700, 256)]
    outs = {}
    for name, kw in (("single", {}), ("sharded", {"mesh": mesh})):
        eng = E.SpMMEngine(inc, max_wave_cols=512, device="cuda", **kw)
        K.reset_launches()
        for i, p in enumerate(panels):
            eng.submit(E.SpMMRequest(i, p))
        outs[name] = {r.rid: r.out for r in eng.run()}
        launches = sum(K.LAUNCHES.values())
        assert launches == eng.stats["waves"] * (8 if kw else 1)
    for i in outs["single"]:
        np.testing.assert_array_equal(outs["sharded"][i], outs["single"][i])
    assert eng.sharded and eng._serial_launches() == 8
    lyr = api.Linear.from_dense(a.T, dataclasses.replace(
        api.SparseSpec("incrs", section=256, block=32), mesh=mesh))
    eng.swap_pattern(lyr.inner)
    new = spat.magnitude_repack(lyr.inner, 0.02)
    eng.swap_pattern(new)
    assert eng.pattern_version == 1
    eng.submit(E.SpMMRequest(9, panels[1]))
    out = eng.run()[-1].out
    want = lin.incrs_sharded_to_dense_weight(new).T.astype(np.float64) @ \
        panels[1].astype(np.float64)
    assert np.abs(out - want).max() <= F64_TOL * np.abs(want).max()


@pytest.mark.gpu
def test_multi_card_mesh(cuda):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"one card visible ({n}); a mesh over distinct cards "
                    f"needs two or more")
    a, inc = _operand(seed=4)
    mesh = make_mesh(n, "cuda")
    prep = ops.prepare_incrs_sharded(inc, mesh)
    assert len(set(prep.devices)) == n
    b = torch.randn(a.shape[1], 256, device=cuda)
    want = ops.spmm(ops.prepare_incrs(inc, device=cuda), b)
    assert torch.equal(ops.spmm(prep, b), want)


@pytest.mark.gpu
def test_launcher_shards_on_one_card(cuda):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--spmm",
         "--spmm-shards", "8", "--device", "cuda:0", "--n-requests", "4",
         "--spmm-swap"], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "8-way row-sharded over ['cuda:0']" in proc.stdout
    if torch.cuda.device_count() < 8:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--spmm",
             "--spmm-shards", "8", "--device", "cuda"], env=env,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and "needs 8 visible" in proc.stderr
