"""The port's LM training path on the card: the train-mode attention
repair (a long sequence trains through the chunked torch attention, never
the flash kernel, which refuses inputs that require grad), a two-stage
InCRS pipeline on one card named twice, and one smoke LM step against the
same step on the CPU.

This file imports nothing of JAX, so it runs on a machine that has the
card and no JAX: ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_cuda_lm_train.py``. On a machine without CUDA every test
skips.

Tolerances: gradients and parameters on the card against the CPU's
``1e-4 * max|ref|`` per tensor (f32 throughout, TF32 off; sums in another
order); the pipeline's forward bitwise equal to its stages applied one
after another (the same kernel launches on the same inputs).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs                           # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens     # noqa: E402
from repro_torch.kernels import flash_attention as F      # noqa: E402
from repro_torch.kernels import incrs_spmm as K           # noqa: E402
from repro_torch.kernels import ops                       # noqa: E402
from repro_torch.launch.mesh import make_mesh             # noqa: E402
from repro_torch.models import layers                     # noqa: E402
from repro_torch.models import model as M                 # noqa: E402
from repro_torch.sparse import api                        # noqa: E402
from repro_torch.sparse import linear as lin              # noqa: E402
from repro_torch.train import optimizer as O              # noqa: E402
from repro_torch.train import pipeline as P               # noqa: E402
from repro_torch.train import trainer                     # noqa: E402

TOL = 1e-4

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol=TOL):
    got, want = got.detach().cpu(), want.detach().cpu()
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= tol * scale, (err, scale)


def _narrow(**over):
    return dataclasses.replace(
        configs.get_smoke("granite-34b"), n_layers=1, d_model=32, n_heads=2,
        n_kv_heads=1, d_ff=64, vocab_size=256, **over)


def test_long_train_sequence_trains_off_the_kernel(cuda, monkeypatch):
    """S = 2 * threshold in train mode: no flash launch, wq/wk/wv get
    nonzero gradients equal to the CPU model's."""
    monkeypatch.setattr(layers, "FLASH_THRESHOLD", 512)
    cfg = _narrow(flash_chunk=128)
    batch = SyntheticTokens(cfg.vocab_size, 1, 1024, seed=2).batch_at(0)
    grads = {}
    for dev in ("cpu", cuda):
        model = M.init(cfg, seed=4, device="cpu").to(dev)
        F.reset_launches()
        _, grads[str(dev)] = trainer.loss_and_grads(model, batch)
        assert F.LAUNCHES["flash_attention"] == 0
    for name in ("wq", "wk", "wv"):
        key = f"blocks.0.mixer.{name}"
        assert float(grads["cuda"][key].abs().max()) > 0
        _close(grads["cuda"][key], grads["cpu"][key])
    for key in grads["cpu"]:
        _close(grads["cuda"][key], grads["cpu"][key])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_refuses_grad_inputs_on_the_card(cuda, dtype):
    q = torch.randn(1, 200, 1, 4, 64, device=cuda, dtype=dtype)
    k = torch.randn(1, 200, 1, 64, device=cuda, dtype=dtype)
    v = torch.randn(1, 200, 1, 64, device=cuda, dtype=dtype)
    F.reset_launches()
    with pytest.raises(ValueError, match="P5"):
        ops.flash_mha(q.requires_grad_(), k, v)
    assert F.LAUNCHES["flash_attention"] == 0
    with torch.no_grad():
        out = ops.flash_mha(q, k, v)
    assert F.LAUNCHES["flash_attention"] == 1
    assert out.grad_fn is None
    # a prefill still launches the kernel
    cfg = _narrow()
    model = M.init(cfg, seed=1, device=cuda)
    old = layers.FLASH_THRESHOLD
    layers.FLASH_THRESHOLD = 64
    try:
        F.reset_launches()
        M.prefill_step(model, torch.zeros(1, 80, dtype=torch.long,
                                          device=cuda), alloc_seq=96)
    finally:
        layers.FLASH_THRESHOLD = old
    assert F.LAUNCHES["flash_attention"] == cfg.n_layers


def test_two_stage_pipeline_on_one_card(cuda):
    """Two InCRS stages on cuda:0 twice: the forward bitwise equal to the
    stages applied one microbatch at a time, n_stages * n_micro forward
    and as many dx launches, the gradients equal to the same pipeline's
    on the CPU."""
    spec = api.SparseSpec("incrs", density=0.1, section=64, block=8)
    stacks = {dev: api.stack_init(2, 256, 256, spec,
                                  generator=torch.Generator().manual_seed(3),
                                  device=dev) for dev in ("cpu", "cuda")}
    gen = torch.Generator().manual_seed(4)
    x0 = torch.randn(4, 64, 256, generator=gen)
    stage = P.incrs_stage_fn()
    outs, grads = {}, {}
    for dev, mesh in (("cpu", make_mesh(2, "cpu", axis="pipe")),
                      ("cuda", make_mesh(2, "cuda:0", axis="pipe"))):
        stack = stacks[dev]
        x = x0.to(dev, copy=True).requires_grad_()
        K.reset_launches()
        out = P.pipeline_apply(stage, stack, x, n_stages=2, n_micro=4,
                               mesh=mesh)
        fwd = sum(K.LAUNCHES.values())
        out.square().mean().backward()
        if dev == "cuda":
            assert fwd == 8 and sum(K.LAUNCHES.values()) == 16
            with torch.no_grad():
                for m in range(4):
                    h = x[m]
                    for i in range(2):
                        h = stage(lin.InCRSLinearParams(stack.values[i],
                                                        stack.meta), h)
                    assert torch.equal(out[m], h)
        outs[dev], grads[dev] = out, (stack.values.grad, x.grad)
    _close(outs["cuda"], outs["cpu"])
    for a, b in zip(grads["cuda"], grads["cpu"]):
        _close(a, b)
    live = stacks["cuda"].meta.fwd_idx >= 0
    assert float(grads["cuda"][0][:, ~live].abs().max()) == 0.0


def test_one_smoke_lm_step_on_the_card(cuda):
    """A smoke LM step (remat "dots", two microbatches, AdamW in place) on
    the card against the same step on the CPU."""
    cfg = dataclasses.replace(configs.get_smoke("granite-34b"),
                              remat_policy="dots")
    opt = O.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    batch = SyntheticTokens(cfg.vocab_size, 4, 64, seed=5).batch_at(0)
    res = {}
    for dev in ("cpu", cuda):
        model, state = trainer.init_train_state(cfg, opt, seed=6,
                                                device="cpu")
        model = model.to(dev)
        state = O.adamw_init(opt, dict(model.named_parameters()))
        step = trainer.build_train_step(cfg, opt, n_micro=2)
        losses = []
        for _ in range(2):
            model, state, m = step(model, state, batch)
            losses.append(m["loss"])
        res[str(dev)] = (losses, dict(model.named_parameters()))
    for a, b in zip(res["cuda"][0], res["cpu"][0]):
        _close(a, b)
    for name, p in res["cpu"][1].items():
        _close(res["cuda"][1][name], p)
