"""The sharded LM on the card: a (data 2, model 4) mesh of one card named
eight times, granite-34b's smoke config (one kv head), against the same
model on one device of the card; and the MoE, SSD and RG-LRU families'
smoke configs and the block-sparse FFN there in float64 (``_sharded_lm``:
a route that flips in f32 is no fault of the mesh), held as on the CPU.

This file imports nothing of JAX, so it runs on a machine that has the
card and no JAX: ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_cuda_lm_sharded.py``. On a machine without CUDA every
test skips.

Tolerances (f32, TF32 off; the shards sum in another order): the loss rtol
1e-5, each gathered gradient and first moment ``1e-4 * max|ref|``; the
prefill and decode logits ``1e-4 * max|logit|``. A prefill of 8,192
positions launches the flash kernel once a coordinate a layer. The
planted fault (layer 0's ``wo`` all-reduce dropped) must take the
gradients out of their bound.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs                           # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens     # noqa: E402
from repro_torch.kernels import flash_attention as F      # noqa: E402
from repro_torch.models import layers                     # noqa: E402
from repro_torch.models import model as M                 # noqa: E402
from repro_torch.models import sharding as sh             # noqa: E402
from repro_torch.models import spmd                       # noqa: E402
from repro_torch.train import optimizer as O              # noqa: E402
from repro_torch.train import trainer as T                # noqa: E402
from repro_torch.train.zero import FSDP_OVERRIDES         # noqa: E402

TOL = 1e-4

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mesh():
    import numpy as np
    from repro_torch.launch.mesh import Mesh
    return Mesh(np.full((2, 4), "cuda:0", dtype=object), ("data", "model"))


def _rel(got, want):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def _step(cuda):
    """(loss rel. error, worst gradient error, worst moment error) of one
    FSDP + ZeRO-1 step against one device."""
    cfg = configs.get_smoke("granite-34b")
    model = M.init(cfg, seed=0, device=cuda)
    batch = SyntheticTokens(cfg.vocab_size, 8, 64, seed=1).batch_at(0)
    opt = O.AdamWConfig(lr=1e-3, warmup_steps=0)
    mesh = _mesh()
    sm = spmd.shard_model(model, mesh, FSDP_OVERRIDES)
    loss1, g1 = T.loss_and_grads(model, batch)
    st1 = O.adamw_init(opt, dict(model.named_parameters()))
    O.adamw_update(opt, g1, st1, dict(model.named_parameters()))
    with sh.axis_rules(mesh, FSDP_OVERRIDES):
        ms = T.moment_specs(opt, sm)
        st2 = T.init_sharded_opt_state(opt, sm)
        loss2, parts = T.sharded_loss_and_grads(sm, batch)
        red = T.reduce_grads(sm, parts, ms)
        O.sharded_adamw_update(opt, red, st2, sm, ms)
    gerr = max(_rel(O.moment_sharded(sm, k, ms[k], red[k]).full(), g)
               for k, g in g1.items())
    merr = max(_rel(st2["m"][k].full(), m) for k, m in st1["m"].items())
    assert all(t.is_cuda for t in sm.params["embed"].shards)
    return abs(float(loss2) / float(loss1) - 1), gerr, merr


def test_sharded_step_on_the_card(cuda):
    lerr, gerr, merr = _step(cuda)
    assert lerr < 1e-5 and gerr < TOL and merr < TOL, (lerr, gerr, merr)


def test_planted_wo_fault_fails_on_the_card(cuda, monkeypatch):
    real, seen = layers._row_reduce, []

    def drop_first_wo(outs, sm, axes, what):
        seen.append(what)
        if what == "wo" and seen.count("wo") == 1:
            return outs
        return real(outs, sm, axes, what)
    monkeypatch.setattr(layers, "_row_reduce", drop_first_wo)
    lerr, gerr, _ = _step(cuda)
    # the partial attention output is small against the residual at the
    # init's scale, so the loss may hardly move; the gradients do
    assert "wo" in seen and gerr > TOL, (lerr, gerr)


def test_sharded_prefill_launches_flash_a_coordinate(cuda):
    """2 x 8,192 positions: 8 coordinates x 2 layers = 16 flash launches,
    the logits within 1e-4 of one device's, and again after 2 decode
    steps."""
    cfg = configs.get_smoke("granite-34b")
    model = M.init(cfg, seed=0, device=cuda)
    sm = spmd.shard_model(model, _mesh())
    tok = torch.randint(0, cfg.vocab_size, (2, layers.FLASH_THRESHOLD),
                        generator=torch.Generator().manual_seed(0))
    alloc = layers.FLASH_THRESHOLD + 2
    l1, c1 = M.prefill_step(model, tok, alloc_seq=alloc,
                            cache_dtype=torch.float32)
    F.reset_launches()
    l2, c2 = M.prefill_step(sm, tok, alloc_seq=alloc,
                            cache_dtype=torch.float32)
    torch.cuda.synchronize()
    assert F.LAUNCHES["flash_attention"] == 8 * cfg.n_layers
    assert _rel(l2.full(), l1) < TOL
    for t in range(2):
        nt = tok[:, t:t + 1]
        l1, c1 = M.decode_step(model, nt, c1, pos=layers.FLASH_THRESHOLD + t)
        l2, c2 = M.decode_step(sm, nt, c2, pos=layers.FLASH_THRESHOLD + t)
        assert _rel(l2.full(), l1) < TOL


FAMILIES = ("mixtral-8x7b", "qwen2-moe-a2.7b", "mamba2-370m",
            "recurrentgemma-2b")


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_step_on_the_card(cuda, arch):
    """One FSDP + ZeRO-1 step of the family's smoke config in float64:
    the loss rtol 1e-6, gradients and first moments within 1e-6 of max."""
    from _sharded_lm import batch, cfg_of, init, step_errors
    cfg = cfg_of(arch)
    lerr, gerr, merr, sm = step_errors(init(cfg, device=cuda), batch(cfg),
                                       (2, 4), FSDP_OVERRIDES,
                                       device="cuda:0")
    assert lerr < 1e-6 and gerr < 1e-6 and merr < 1e-6, (lerr, gerr, merr)
    assert all(t.is_cuda for t in sm.params["embed"].shards)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_prefill_and_decode_on_the_card(cuda, arch):
    """A prefill of 16 positions and 3 decode steps in float64: logits
    within 1e-5 of max|logit| of one device on the card."""
    from _sharded_lm import cfg_of, init, mesh, serve_errors
    model = init(cfg_of(arch), device=cuda)
    errs, _, _ = serve_errors(model, spmd.shard_model(model,
                                                      mesh((2, 4), "cuda:0")))
    assert max(errs) < 1e-5, errs


def test_block_sparse_step_on_the_card(cuda):
    """The sparse-FFN example's config, half of the mask blocks zeroed,
    one FSDP step in float64 held to one device."""
    from _sharded_lm import batch, cfg_of, init, step_errors
    from repro_torch.examples import train_sparse_lm
    cfg = cfg_of(train_sparse_lm.build("sparse-lm", 128, 2, 512, True, 32))
    model = init(cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():
        for _, m in model.named_buffers():
            m.copy_(torch.rand(m.shape, generator=gen, device=cuda) < 0.5)
    lerr, gerr, merr, _ = step_errors(model, batch(cfg), (2, 4),
                                      FSDP_OVERRIDES, device="cuda:0")
    assert lerr < 1e-6 and gerr < 1e-6 and merr < 1e-6, (lerr, gerr, merr)
