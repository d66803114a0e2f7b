"""The port's flash-attention kernel and LM stack on the card: the kernel
against its plain torch version over types, head dims, group sizes,
windows, soft caps and ragged lengths; the wrapper's refusals; one launch
per ``ops.flash_mha``; a smoke-width model and ``ServeEngine`` prefilling
through the kernel; the MoE FFN against the CPU and run to run, its ties,
and an embeds prefill through the kernel.

This file imports nothing of JAX, so it runs on a machine that has the card
and no JAX: ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_cuda_lm.py`` (the shared conftest imports JAX). On a
machine without CUDA every test skips.

Tolerances: f32 kernel against the plain f32 version ``1e-5 * max|out|``
(sums in another order); bf16 kernel (the tensor-core one) against the
plain version run in f32 on the same bf16 inputs ``1e-2`` of each query
row's own max|out| (``F.worst_row_error``: bf16 rounding of P and of the
output is 2^-8; a bound on the whole output's max would let an error of
the long rows, whose outputs are small, through); model logits on the
card against the same model on the CPU ``1e-4`` (f32 throughout); an
MoE layer's output and grads ``1e-4`` of each tensor's max against the
CPU, bitwise against its repeat.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs                           # noqa: E402
from repro_torch.kernels import flash_attention as F      # noqa: E402
from repro_torch.kernels import ops                       # noqa: E402
from repro_torch.models import layers                     # noqa: E402
from repro_torch.models import model as M                 # noqa: E402
from repro_torch.serve import engine as E                 # noqa: E402

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LOGIT_TOL = 1e-4

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, s, kv, g, hd, dtype, seed=0, sk=None):
    gen = torch.Generator().manual_seed(seed)
    sk = s if sk is None else sk
    q = torch.randn(b, s, kv, g, hd, generator=gen)
    k = torch.randn(b, sk, kv, hd, generator=gen)
    v = torch.randn(b, sk, kv, hd, generator=gen)
    return (t.to(dtype) for t in (q, k, v))


# (B, S, KV, G, hd, window, soft cap)
CASES = [
    (2, 1, 2, 3, 64, None, None),
    (2, 63, 2, 3, 16, None, None),
    (2, 65, 1, 4, 128, None, None),
    (1, 200, 2, 3, 64, 37, 6.0),
    (1, 300, 1, 2, 32, 64, None),
    (1, 1000, 1, 8, 128, None, 30.0),
    (1, 257, 2, 2, 256, 100, None),
    (1, 130, 3, 1, 24, None, None),
    (2, 129, 1, 5, 200, 7, 2.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,kv,g,hd,window,cap", CASES)
def test_kernel_matches_plain(cuda, dtype, b, s, kv, g, hd, window, cap):
    q, k, v = (t.to(cuda) for t in _qkv(b, s, kv, g, hd, dtype))
    out = F.flash_attention(q, k, v, window=window, soft_cap=cap)
    torch.cuda.synchronize()
    want = F.plain(q.float(), k.float(), v.float(), window=window,
                   soft_cap=cap)
    assert out.dtype == dtype and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    if dtype == torch.bfloat16:
        assert F.worst_row_error(out, want) <= TOL[dtype]
    else:
        err = float((out.float() - want).abs().max())
        assert err <= TOL[dtype] * float(want.abs().max())


@pytest.mark.parametrize("sq,sk", [(100, 50), (50, 100), (70, 0)])
def test_kernel_with_sq_unlike_sk(cuda, sq, sk):
    q, k, v = (t.to(cuda) for t in _qkv(1, sq, 1, 2, 64, torch.float32,
                                        sk=sk))
    out = F.flash_attention(q, k, v)
    want = F.plain(q, k, v)
    assert float((out - want).abs().max()) <= \
        1e-5 * max(float(want.abs().max()), 1.0)


def test_kernel_reads_strided_inputs(cuda):
    """q, k, v as views of a fused projection, as a layout may give them:
    the kernel reads them through their strides."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    fused = torch.randn(2, 90, 6, 64, generator=gen, device=cuda)
    q = fused[:, :, :4].unflatten(2, (1, 4))
    k, v = fused[:, :, 4:5], fused[:, :, 5:6]
    assert not q.is_contiguous()
    out = F.flash_attention(q, k, v, window=20)
    want = F.plain(q.contiguous(), k.contiguous(), v.contiguous(),
                   window=20)
    assert float((out - want).abs().max()) <= \
        1e-5 * float(want.abs().max())


def test_kernel_refusals(cuda):
    q, k, v = (t.to(cuda) for t in _qkv(1, 16, 1, 2, 64, torch.float32))
    with pytest.raises(ValueError, match="multiple of 8 up to 256"):
        F.flash_attention(*(t.to(cuda) for t in _qkv(1, 16, 1, 2, 264,
                                                     torch.float32)))
    with pytest.raises(ValueError, match="multiple of 8 up to 256"):
        F.flash_attention(*(t.to(cuda) for t in _qkv(1, 16, 1, 2, 20,
                                                     torch.float32)))
    with pytest.raises(TypeError, match="floating point"):
        F.flash_attention(q.int(), k.int(), v.int())
    with pytest.raises(TypeError, match="f32 or bf16"):
        F.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="one type"):
        F.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="one device"):
        F.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="contiguous in its head dim"):
        F.flash_attention(q, k.transpose(1, 3).contiguous().transpose(1, 3),
                          v)


def test_one_launch_per_flash_mha(cuda):
    q, k, v = (t.to(cuda) for t in _qkv(2, 100, 2, 3, 64, torch.bfloat16))
    F.reset_launches()
    for n in (1, 2, 3):
        ops.flash_mha(q, k, v, window=50, soft_cap=5.0, bq=128, bk=128)
        assert F.LAUNCHES["flash_attention"] == n


# The bf16 tensor-core kernel (flash_kernel_bf16) against the plain version
# in f32 on the same bf16 inputs, 1e-2 of each query row's max|out|.
def _bf16_close(out, q, k, v, window=None, cap=None):
    want = F.plain(q.float(), k.float(), v.float(), window=window,
                   soft_cap=cap)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    assert F.worst_row_error(out, want) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("hd", [16, 24, 64, 128, 256])
@pytest.mark.parametrize("s", [1, 63, 65, 200, 1000])
def test_bf16_tensor_core_kernel_over_head_dims_and_lengths(cuda, hd, s):
    q, k, v = (t.to(cuda) for t in _qkv(2, s, 2, 3, hd, torch.bfloat16,
                                        seed=hd + s))
    F.reset_launches()
    out = F.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert F.ROUTE_LAUNCHES == {"f32_fma": 0, "bf16_wgmma": 1}
    _bf16_close(out, q, k, v)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("window,cap", [(37, None), (None, 6.0),
                                        (100, 30.0), (1, None),
                                        (5000, None)])
def test_bf16_kernel_with_window_and_cap(cuda, hd, window, cap):
    q, k, v = (t.to(cuda) for t in _qkv(2, 300, 1, 4, hd, torch.bfloat16,
                                        seed=7))
    out = F.flash_attention(q, k, v, window=window, soft_cap=cap)
    _bf16_close(out, q, k, v, window, cap)


@pytest.mark.parametrize("sq,sk", [(100, 50), (50, 100), (70, 0),
                                   (300, 129), (129, 300)])
def test_bf16_kernel_with_sq_unlike_sk(cuda, sq, sk):
    q, k, v = (t.to(cuda) for t in _qkv(1, sq, 1, 2, 64, torch.bfloat16,
                                        sk=sk))
    out = F.flash_attention(q, k, v)
    _bf16_close(out, q, k, v)


def test_bf16_kernel_reads_strided_inputs(cuda):
    """A fused bf16 projection, as a layout may give it: TMA reads the
    views through their strides, with no copy."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    fused = torch.randn(2, 90, 6, 64, generator=gen, device=cuda).bfloat16()
    q = fused[:, :, :4].unflatten(2, (1, 4))
    k, v = fused[:, :, 4:5], fused[:, :, 5:6]
    assert not q.is_contiguous()
    _bf16_close(F.flash_attention(q, k, v, window=20), q, k, v, 20)


def test_bf16_kernel_at_granite_width(cuda):
    """granite-34b's attention: 48 query heads on one KV head, hd 128."""
    q, k, v = (t.to(cuda) for t in _qkv(1, 2048, 1, 48, 128, torch.bfloat16,
                                        seed=11))
    _bf16_close(F.flash_attention(q, k, v), q, k, v)


def test_each_type_launches_its_own_kernel(cuda):
    q, k, v = (t.to(cuda) for t in _qkv(1, 100, 1, 2, 64, torch.float32))
    F.reset_launches()
    F.flash_attention(q, k, v)
    assert F.ROUTE_LAUNCHES == {"f32_fma": 1, "bf16_wgmma": 0}
    F.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert F.ROUTE_LAUNCHES == {"f32_fma": 1, "bf16_wgmma": 1}
    assert F.LAUNCHES["flash_attention"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("sq,sk,window", [(100, 300, None), (65, 1000, 30),
                                          (130, 257, None)])
def test_kernel_never_loads_key_tiles_no_query_sees(cuda, dtype, sq, sk,
                                                   window):
    """Keys past Sq are seen by no query: the 64-key tiles that hold only
    such keys are filled with NaN, which any load into a product would
    spread (0 * NaN), and the output still matches the plain version on
    the clean keys. The kernel's own walk of the key tiles is what skips
    them."""
    q, k, v = (t.to(cuda) for t in _qkv(1, sq, 1, 3, 64, dtype, sk=sk))
    first = -(-sq // F.KEY_TILE) * F.KEY_TILE
    kn, vn = k.clone(), v.clone()
    kn[:, first:] = float("nan")
    vn[:, first:] = float("nan")
    out = F.flash_attention(q, kn, vn, window=window)
    want = F.plain(q.float(), k.float(), v.float(), window=window)
    assert bool(torch.isfinite(out).all())
    if dtype == torch.bfloat16:
        assert F.worst_row_error(out, want) <= TOL[dtype]
    else:
        assert float((out - want).abs().max()) <= \
            TOL[dtype] * float(want.abs().max())


def _smoke_models(cuda):
    cfg = configs.get_smoke("granite-34b")
    model = M.init(cfg, seed=0, device=cuda)
    cpu = M.Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return cfg, model, cpu


def test_model_prefill_launches_once_per_layer(cuda, monkeypatch):
    cfg, model, cpu = _smoke_models(cuda)
    monkeypatch.setattr(layers, "FLASH_THRESHOLD", 32)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 100))
    F.reset_launches()
    logits, cache = M.prefill_step(model, toks, alloc_seq=120,
                                   cache_dtype=torch.float32)
    assert F.LAUNCHES["flash_attention"] == cfg.n_layers
    want, _ = M.prefill_step(cpu, toks, alloc_seq=120,
                             cache_dtype=torch.float32)
    np.testing.assert_allclose(logits.cpu().numpy(), want.numpy(),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # a prompt below the threshold and the decode steps launch nothing
    M.prefill_step(model, toks[:, :20], alloc_seq=40)
    M.decode_step(model, toks[:, :1], cache, pos=100)
    assert F.LAUNCHES["flash_attention"] == cfg.n_layers


def test_serve_engine_on_cuda_matches_the_cpu(cuda, monkeypatch):
    cfg, model, cpu = _smoke_models(cuda)
    monkeypatch.setattr(layers, "FLASH_THRESHOLD", 32)
    rng = np.random.default_rng(1)
    spec = [(40, 5), (40, 3), (12, 4), (40, 0), (12, 6)]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _ in spec]
    outs = []
    F.reset_launches()
    for m in (model, cpu):
        eng = E.ServeEngine(m, n_slots=4, cache_dtype=torch.float32, seed=2)
        for i, (p, (_, mx)) in enumerate(zip(prompts, spec)):
            eng.submit(E.Request(i, p, max_new=mx))
        outs.append({r.rid: r.out for r in eng.run()})
    assert outs[0] == outs[1]
    assert [len(outs[0][i]) for i in range(5)] == [5, 3, 4, 0, 6]
    # one wave of 40-token prompts reaches the kernel, once per layer
    assert F.LAUNCHES["flash_attention"] == cfg.n_layers


def test_full_width_granite_layer_on_the_card(cuda):
    """One granite-34b block at full width (d_model 6144, 48 heads, one KV
    head) prefilling 8,192 tokens in bf16 through the kernel."""
    cfg = dataclasses.replace(configs.get("granite-34b"), n_layers=1)
    model = M.init(cfg, seed=0, device=cuda)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 8192))
    F.reset_launches()
    logits, cache = M.prefill_step(model, toks, alloc_seq=8200)
    assert F.LAUNCHES["flash_attention"] == 1
    assert logits.shape == (1, cfg.padded_vocab())
    assert bool(torch.isfinite(logits).all())
    assert cache[0]["k"].dtype == torch.bfloat16 and cache[0]["end"] == 8192


# ----------------------------------------------------------------------
# The MoE FFN and the embeds front end on the card.
def _moe_pair(cuda, name="qwen2-moe-a2.7b", seed=0):
    """One MoE layer of ``name``'s smoke config (f32), on the card and on
    the CPU with the same weights."""
    cfg = configs.get_smoke(name)
    gen = torch.Generator().manual_seed(seed)
    cpu = layers.MoE(cfg, device="cpu")
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    card = layers.MoE(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    return cfg, cpu, card


def _moe_run(layer, x, mode="train"):
    """Output, input grad and parameter grads of one call."""
    layer.zero_grad(set_to_none=True)
    x = x.clone().requires_grad_()
    out = layer(x, mode=mode)
    (out * torch.linspace(-1, 1, out.shape[-1], device=out.device)).sum() \
        .backward()
    return [out.detach(), x.grad] + [p.grad for p in layer.parameters()]


@pytest.mark.parametrize("name,mode,s", [
    ("qwen2-moe-a2.7b", "train", 40), ("mixtral-8x7b", "train", 40),
    ("mixtral-8x7b", "decode", 1)])
def test_moe_layer_on_the_card_matches_the_cpu_and_repeats(cuda, name, mode,
                                                           s):
    """Forward and grads within 1e-4 of each tensor's max of the same
    layer on the CPU (the same routing), and bitwise equal run to run."""
    cfg, cpu, card = _moe_pair(cuda, name)
    x = torch.randn(2, s, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    cpu.route_log, card.route_log = [], []
    want = _moe_run(cpu, x, mode)
    got = _moe_run(card, x.to(cuda), mode)
    assert torch.equal(card.route_log[0].topi.cpu(), cpu.route_log[0].topi)
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= \
            LOGIT_TOL * float(w.abs().max())
    again = _moe_run(card, x.to(cuda), mode)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_moe_ties_go_to_the_lower_expert_on_the_card(cuda):
    """A zero router ties every expert: each token takes experts 0..k-1
    (``jax.lax.top_k``'s order), bf16 logits tied in blocks likewise."""
    cfg, _, card = _moe_pair(cuda)
    k = cfg.n_experts_per_tok
    with torch.no_grad():
        card.router.zero_()
    card.route_log = []
    x = torch.randn(2, 30, cfg.d_model, device=cuda)
    with torch.no_grad():
        card(x, mode="train")
        card(x.bfloat16(), mode="train")
    for r in card.route_log:
        assert r.topi.unique().tolist() == list(range(k))
    gen = torch.Generator().manual_seed(3)
    base = torch.randn(2, 16, 2, generator=gen)
    pick = torch.randint(0, 2, (cfg.n_experts,), generator=gen)
    logits = base[..., pick].bfloat16().float()
    _, got = layers.top_k_lower(logits.to(cuda), k)
    order = torch.sort(-logits, dim=-1, stable=True).indices[..., :k]
    assert torch.equal(got.cpu(), order)


def test_embeds_prefill_launches_flash_once_a_layer(cuda):
    """internvl2-1b's smoke model: 8,192 positions, prefix included, take
    the flash kernel once a layer, within 1e-4 of the CPU."""
    cfg = configs.get_smoke("internvl2-1b")
    model = M.init(cfg, seed=0, device=cuda)
    cpu = M.Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    s = 8192 - cfg.n_prefix_embeds
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, s))
    pfx = torch.randn(1, cfg.n_prefix_embeds, cfg.d_model,
                      generator=torch.Generator().manual_seed(5))
    F.reset_launches()
    logits, cache = M.prefill_step(model, toks, prefix_embeds=pfx.to(cuda),
                                   alloc_seq=8200, cache_dtype=torch.float32)
    assert F.LAUNCHES["flash_attention"] == cfg.n_layers
    assert cache[0]["end"] == 8192
    want, _ = M.prefill_step(cpu, toks, prefix_embeds=pfx, alloc_seq=8200,
                             cache_dtype=torch.float32)
    np.testing.assert_allclose(logits.cpu().numpy(), want.numpy(),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
