"""The port's LM stack (configs, flash attention, layers, model, serving
engine, launcher) against the JAX package on the CPU, the MoE, embeds and
recurrent (SSD, RG-LRU) architectures included (their prefix embeds in the
logits, the engines' tokens, the cache that counts the prefix).

Inputs are made with numpy from a seed and handed to both packages. The
port's flash attention on the CPU is its plain version; the JAX side runs
the Pallas kernel in interpret mode and ``layers._flash_attention`` with
positions 0..S-1. Where a test needs the flash branch at a small S it
lowers ``FLASH_THRESHOLD`` in both ``repro.models.layers`` and the port's
``layers``. Tolerances: attention rtol = atol = 2e-5 (the JAX kernel
test's own); logits rtol = atol = 1e-4 (f32 throughout, sums in another
order); served token lists are equal.
"""
import dataclasses

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401

torch = pytest.importorskip("torch")

import jax                                                # noqa: E402
import jax.numpy as jnp                                   # noqa: E402
from _recurrent_draw import MIXER_LEAVES, draw_mixer_leaf # noqa: E402

from repro import configs as jconfigs                     # noqa: E402
from repro.kernels import ops as jops                     # noqa: E402
from repro.models import config as jconfig                # noqa: E402
from repro.models import layers as jlayers                # noqa: E402
from repro.models import model as jmodel                  # noqa: E402
from repro.serve import engine as jeng                    # noqa: E402
from repro_torch import configs as tconfigs               # noqa: E402
from repro_torch import convert                           # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops as tops               # noqa: E402
from repro_torch.models import config as tconfig          # noqa: E402
from repro_torch.models import layers as tlayers          # noqa: E402
from repro_torch.models import model as tmodel            # noqa: E402
from repro_torch.serve import engine as teng              # noqa: E402

ATTN_TOL = 2e-5
LOGIT_TOL = 1e-4
# the JAX registry's ten, in its order
PORTED = ("musicgen-medium", "mamba2-370m", "mixtral-8x7b", "qwen2-moe-a2.7b",
          "internvl2-1b", "granite-34b", "phi3-medium-14b",
          "mistral-large-123b", "llama3-405b", "recurrentgemma-2b")
# the MoE and embeds architectures (ROADMAP queue 1 item 12a)
FAMILIES = ("mixtral-8x7b", "qwen2-moe-a2.7b", "musicgen-medium",
            "internvl2-1b")


def _as_dict(cfg):
    return {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(cfg)}


# ----------------------------------------------------------------------
def test_model_config_copies_jax_field_for_field():
    def fields(cls):
        return [(f.name, f.default, str(f.type))
                for f in dataclasses.fields(cls)]
    assert fields(tconfig.ModelConfig) == fields(jconfig.ModelConfig)
    assert fields(tconfig.BlockSparsity) == fields(jconfig.BlockSparsity)
    assert _as_dict(tconfig.BlockSparsity()) == \
        _as_dict(jconfig.BlockSparsity())
    kw = dict(name="t", n_layers=4, d_model=96, n_heads=6, n_kv_heads=2,
              d_ff=160, vocab_size=3000)
    t, j = tconfig.ModelConfig(**kw), jconfig.ModelConfig(**kw)
    assert (t.q_per_kv, t.n_groups, t.padded_vocab(), t.param_count()) == \
        (j.q_per_kv, j.n_groups, j.padded_vocab(), j.param_count())
    with pytest.raises(ValueError, match="multiple of n_kv_heads"):
        tconfig.ModelConfig(**{**kw, "n_kv_heads": 4})


@pytest.mark.parametrize("name", PORTED)
def test_ported_configs_equal_jax(name):
    assert tconfigs.ARCH_NAMES == PORTED
    for get in ("get", "get_smoke"):
        t, j = getattr(tconfigs, get)(name), getattr(jconfigs, get)(name)
        assert _as_dict(t) == _as_dict(j)
        assert (t.q_per_kv, t.n_groups, t.padded_vocab(),
                t.param_count()) == (j.q_per_kv, j.n_groups,
                                     j.padded_vocab(), j.param_count())


def test_unported_architectures_name_their_roadmap_item():
    """No architecture is refused now: the registry is JAX's ten, in its
    order, ``UNPORTED`` is gone, and the SSD and RG-LRU architectures
    build, from the registry and from a config built by hand, with their
    mixers."""
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert not hasattr(tconfigs, "UNPORTED")
    assert not hasattr(tmodel, "_check_ported")
    for name, mixer in (("mamba2-370m", tlayers.SSD),
                        ("recurrentgemma-2b", tlayers.RGLRU)):
        for get in (tconfigs.get, tconfigs.get_smoke):
            assert get(name) == tconfig.ModelConfig(**_as_dict(
                getattr(jconfigs, get.__name__)(name)))
        model = tmodel.Model(tconfig.ModelConfig(**_as_dict(
            jconfigs.get_smoke(name))), device="cpu")
        assert isinstance(model.blocks[0].mixer, mixer)
    for name in FAMILIES:
        assert tconfigs.get(name) == tconfig.ModelConfig(**_as_dict(
            jconfigs.get(name)))


@pytest.mark.parametrize("name", FAMILIES)
def test_item_12a_archs_build_and_run(name):
    """The four architectures item 12 refused build, run a forward pass
    (with their prefix embeds where they take them) and give finite
    logits of the padded vocabulary."""
    cfg = tconfigs.get_smoke(name)
    model = tmodel.init(cfg, seed=0, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 10))
    npfx = cfg.n_prefix_embeds if cfg.input_mode == "embeds" else 0
    pfx = (np.random.default_rng(1).normal(
        size=(2, npfx, cfg.d_model)).astype(np.float32) if npfx else None)
    with torch.no_grad():
        logits = model(torch.from_numpy(toks), prefix_embeds=pfx)
    assert logits.shape == (2, npfx + 10, cfg.padded_vocab())
    assert bool(torch.isfinite(logits).all())
    assert isinstance(model.blocks[0].ffn,
                      tlayers.MoE if cfg.is_moe else tlayers.MLP)


# ----------------------------------------------------------------------
def _qkv(rng, b, s, kv, g, hd):
    q = rng.normal(size=(b, s, kv, g, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    return q, k, v


# (B, S, KV, G, hd, window, soft cap): tests/test_kernels.py:100-123 and MQA
FLASH_CASES = [
    (2, 200, 2, 3, 64, None, None),
    (2, 200, 2, 3, 64, 37, None),
    (2, 200, 2, 3, 64, None, 6.0),
    (2, 200, 2, 3, 64, 50, 6.0),
    (1, 300, 1, 2, 32, 64, None),
    (2, 150, 1, 4, 64, None, None),
]


@pytest.mark.parametrize("b,s,kv,g,hd,window,cap", FLASH_CASES)
def test_flash_mha_matches_jax(b, s, kv, g, hd, window, cap):
    rng = np.random.default_rng(s + g)
    q, k, v = _qkv(rng, b, s, kv, g, hd)
    got = tops.flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), window=window, soft_cap=cap,
                         bk=64)
    assert got.dtype == torch.float32 and got.shape == q.shape
    want = jops.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          window=window, soft_cap=cap, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=ATTN_TOL, atol=ATTN_TOL)
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    want2 = jlayers._flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, pos,
        window=window, soft_cap=cap, chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want2),
                               rtol=ATTN_TOL, atol=ATTN_TOL)


def test_flash_mha_keeps_dtype_and_refuses_bad_inputs():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 70, 1, 2, 16))
    out = tops.flash_mha(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert out.dtype == torch.bfloat16
    want = tflash.plain(q.bfloat16().float(), k.bfloat16().float(),
                        v.bfloat16().float())
    assert float((out.float() - want).abs().max()) <= \
        1e-2 * float(want.abs().max())
    with pytest.raises(TypeError, match="floating point"):
        tops.flash_mha(q.int(), k, v)
    with pytest.raises(ValueError, match="do not match"):
        tops.flash_mha(q, k[..., :8], v[..., :8])
    with pytest.raises(ValueError, match=r"\(B, Sq, KV, G, hd\)"):
        tops.flash_mha(q[0], k, v)
    with pytest.raises(ValueError, match="bk must be positive"):
        tops.flash_mha(q, k, v, bk=0)
    # the CPU runs the plain version: no kernel launch is counted
    tflash.reset_launches()
    tops.flash_mha(q, k, v)
    assert tflash.LAUNCHES["flash_attention"] == 0


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                         1e-6).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        rtol=1e-6, atol=1e-6)
    pos = rng.integers(0, 5000, size=(2, 5))
    np.testing.assert_allclose(
        tlayers._rope(torch.from_numpy(x), torch.from_numpy(pos),
                      10000.0).numpy(),
        np.asarray(jlayers._rope(jnp.asarray(x), jnp.asarray(pos),
                                 10000.0)),
        rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
MODEL_CASES = {
    "granite": ("granite-34b", {}),
    "phi3": ("phi3-medium-14b", {}),
    "granite_window_cap": ("granite-34b",
                           dict(sliding_window=16, logits_soft_cap=30.0)),
    "granite_block_sparse": ("granite-34b", {}),
    "mixtral": ("mixtral-8x7b", {}),
    "qwen2": ("qwen2-moe-a2.7b", {}),
    "musicgen": ("musicgen-medium", {}),
    "internvl2": ("internvl2-1b", {}),
    "mamba2": ("mamba2-370m", {}),
    "recurrentgemma": ("recurrentgemma-2b", {}),
}
EMBEDS = ("musicgen", "internvl2")


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX params, port model) per case, same weights."""
    out = {}
    for label, (name, over) in MODEL_CASES.items():
        jcfg = dataclasses.replace(jconfigs.get_smoke(name), **over)
        tcfg = dataclasses.replace(tconfigs.get_smoke(name), **over)
        if label == "granite_block_sparse":
            jcfg = dataclasses.replace(
                jcfg, sparsity=jconfig.BlockSparsity(block=16))
            tcfg = dataclasses.replace(
                tcfg, sparsity=tconfig.BlockSparsity(block=16))
        params, _ = jmodel.init(jcfg, jax.random.PRNGKey(0))
        # the recurrent mixers' leaves: their state carries the output
        rng = np.random.default_rng(9)
        params = jax.tree_util.tree_map_with_path(
            lambda path, v: jnp.asarray(draw_mixer_leaf(
                path[-1].key, v.shape, rng), v.dtype)
            if path[-1].key in MIXER_LEAVES else v, params)
        if jcfg.sparsity is not None:
            # the block masks init to ones; prune half the blocks
            ffn = params["groups"]["block0_attn"]["ffn"]
            rng = np.random.default_rng(6)
            for name_ in [k for k in ffn if k.startswith("mask_")]:
                ffn[name_] = jnp.asarray(
                    rng.random(ffn[name_].shape) < 0.5, jnp.float32)
        out[label] = (jcfg, params, convert.model_from_jax(
            tcfg, jax.tree.map(np.asarray, params), device="cpu"))
    return out


@pytest.fixture
def flash_threshold(monkeypatch):
    def set_(n):
        monkeypatch.setattr(jlayers, "FLASH_THRESHOLD", n)
        monkeypatch.setattr(tlayers, "FLASH_THRESHOLD", n)
    return set_


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("threshold", [8192, 32], ids=["dense", "flash"])
@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_forward_matches_jax(models, flash_threshold, case, threshold):
    jcfg, params, model = models[case]
    flash_threshold(threshold)
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 48)).astype(np.int32)
    tflash.reset_launches()
    with torch.no_grad():
        got = model(torch.from_numpy(toks), mode="train")
        got_p, cache = model(torch.from_numpy(toks), mode="prefill")
    _close(got, jmodel.forward(jcfg, params, jnp.asarray(toks),
                               mode="train"))
    want_p, _ = jmodel.forward(jcfg, params, jnp.asarray(toks),
                               mode="prefill")
    _close(got_p, want_p)
    assert len(cache) == jcfg.n_layers and cache[0]["end"] == 48


@pytest.mark.parametrize("case,prompt,threshold", [
    ("granite", 12, 8192),
    ("phi3", 12, 8),
    ("granite_window_cap", 20, 8),     # the ring wraps in prefill and decode
    ("mixtral", 20, 8),                # MoE, the window ring wraps
    ("qwen2", 12, 8192),               # MoE with shared experts
    ("musicgen", 12, 8192),            # embeds: the prefix takes positions
    ("internvl2", 12, 16),
    ("mamba2", 20, 8192),              # SSD: a chunk of 16 and a ragged one
    ("recurrentgemma", 20, 8),         # RG-LRU; the local window wraps
])
def test_prefill_then_decode_match_jax_step_for_step(
        models, flash_threshold, case, prompt, threshold):
    jcfg, params, model = models[case]
    flash_threshold(threshold)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (2, prompt)).astype(np.int32)
    feed = rng.integers(0, jcfg.vocab_size, (8, 2, 1)).astype(np.int32)
    npfx = jcfg.n_prefix_embeds if jcfg.input_mode == "embeds" else 0
    pfx = rng.normal(size=(2, npfx, jcfg.d_model)).astype(np.float32)
    jpfx, tpfx = ((jnp.asarray(pfx), torch.from_numpy(pfx)) if npfx
                  else (None, None))
    alloc = npfx + prompt + 8 + 4
    jl, jc = jmodel.prefill_step(jcfg, params, jnp.asarray(toks),
                                 prefix_embeds=jpfx, alloc_seq=alloc,
                                 cache_dtype=jnp.float32)
    tl, tc = tmodel.prefill_step(model, torch.from_numpy(toks),
                                 prefix_embeds=tpfx, alloc_seq=alloc,
                                 cache_dtype=torch.float32)
    _close(tl, jl)
    if jcfg.sliding_window:
        assert tc[0]["k"].shape[1] == jcfg.sliding_window < alloc
    for step in range(8):
        pos = npfx + prompt + step
        jl, jc = jmodel.decode_step(jcfg, params, jnp.asarray(feed[step]),
                                    jc, pos=pos)
        tl, tc = tmodel.decode_step(model, torch.from_numpy(feed[step]), tc,
                                    pos=pos)
        _close(tl, jl)
    assert tc[0]["end"] == npfx + prompt + 8


@pytest.mark.parametrize("threshold", [8192, 32], ids=["dense", "flash"])
@pytest.mark.parametrize("case", EMBEDS)
def test_prefix_embeds_logits_match_jax(models, flash_threshold, case,
                                        threshold):
    """Train and prefill logits with the front end's embeddings
    prepended, over the prefix and the token segment."""
    jcfg, params, model = models[case]
    flash_threshold(threshold)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    pfx = rng.normal(size=(2, jcfg.n_prefix_embeds, jcfg.d_model)).astype(
        np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(toks), prefix_embeds=torch.from_numpy(
            pfx), mode="train")
        got_p, cache = model(torch.from_numpy(toks), prefix_embeds=pfx,
                             mode="prefill")
    assert got.shape[1] == jcfg.n_prefix_embeds + 40
    for mode, g in (("train", got), ("prefill", got_p)):
        want = jmodel.forward(jcfg, params, jnp.asarray(toks),
                              prefix_embeds=jnp.asarray(pfx), mode=mode)
        _close(g, want if mode == "train" else want[0])
    assert cache[0]["end"] == jcfg.n_prefix_embeds + 40


def _requests(mod, vocab, temperature):
    rng = np.random.default_rng(5)
    lens, max_new = (6, 9, 6, 11, 9, 6), (5, 3, 0, 4, 6, 2)
    return [mod.Request(i, rng.integers(0, vocab, n).astype(np.int32),
                        max_new=m, temperature=temperature)
            for i, (n, m) in enumerate(zip(lens, max_new))]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_serve_engine_matches_jax_engine(models, temperature):
    jcfg, params, model = models["phi3"]
    jdone = jeng.ServeEngine(jcfg, params, n_slots=2,
                             cache_dtype=jnp.float32, seed=7)
    tdone = teng.ServeEngine(model, n_slots=2, cache_dtype=torch.float32,
                             seed=7)
    for eng, mod in ((jdone, jeng), (tdone, teng)):
        for r in _requests(mod, jcfg.vocab_size, temperature):
            eng.submit(r)
    want = {r.rid: r.out for r in jdone.run()}
    got = {r.rid: r.out for r in tdone.run()}
    assert got == want
    assert got[2] == [] and [len(got[i]) for i in range(6)] == \
        [5, 3, 0, 4, 6, 2]
    assert tdone.stats["waves"] == jdone.stats["waves"]
    assert len(tdone.prefill_ms) == tdone.stats["waves"]


@pytest.mark.parametrize("case", ["mixtral", "qwen2", "musicgen",
                                  "internvl2", "mamba2", "recurrentgemma"])
def test_serve_engine_matches_jax_engine_moe_and_embeds(models, case):
    """Both engines' tokens on the MoE, embeds and recurrent smoke configs
    (the embeds engines prefill zero front-end embeddings first; the
    recurrent ones carry a state that no padding token may enter: waves
    are grouped by prompt length)."""
    jcfg, params, model = models[case]
    out = []
    for eng in (jeng.ServeEngine(jcfg, params, n_slots=2,
                                 cache_dtype=jnp.float32, seed=7),
                teng.ServeEngine(model, n_slots=2, cache_dtype=torch.float32,
                                 seed=7)):
        mod = jeng if isinstance(eng, jeng.ServeEngine) else teng
        for r in _requests(mod, jcfg.vocab_size, 0.8):
            eng.submit(r)
        out.append({r.rid: r.out for r in eng.run()})
    assert out[1] == out[0]
    assert [len(out[1][i]) for i in range(6)] == [5, 3, 0, 4, 6, 2]


def test_embeds_mode_alloc_includes_prefix(models, monkeypatch):
    """JAX's regression (``tests/test_serve.py``): the allocation counts
    the prefix, so at ``alloc_extra=0`` decode still has a slot for every
    position up to s + npfx + max_new - 1, and the greedy tokens equal a
    generous allocation's and JAX's."""
    jcfg, params, model = models["internvl2"]
    seen = []
    real = tmodel.prefill_step

    def spy(model_, prompts, **kw):
        seen.append(kw["alloc_seq"])
        return real(model_, prompts, **kw)
    monkeypatch.setattr(tmodel, "prefill_step", spy)
    prompt = np.arange(4, 12, dtype=np.int32)
    outs = []
    for extra in (64, 0):
        eng = teng.ServeEngine(model, n_slots=1, cache_dtype=torch.float32,
                               alloc_extra=extra)
        eng.submit(teng.Request(0, prompt, max_new=6))
        outs.append(eng.run()[0].out)
    assert seen[1] == 8 + jcfg.n_prefix_embeds + 6
    assert outs[0] == outs[1] and len(outs[1]) == 6
    jeng_ = jeng.ServeEngine(jcfg, params, n_slots=1,
                             cache_dtype=jnp.float32, alloc_extra=0)
    jeng_.submit(jeng.Request(0, prompt, max_new=6))
    assert jeng_.run()[0].out == outs[1]


def test_launcher_serves_an_lm_on_cpu(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", "granite-34b", "--smoke", "--device", "cpu",
                     "--n-requests", "3", "--max-new", "4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "arch=granite-34b-smoke served 3 requests, 12 tokens" in out
    assert '"flash_attention": 0' in out
    for arch in ("mixtral-8x7b", "musicgen-medium"):
        assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--n-requests", "2", "--max-new", "3"]) == 0
        assert f"arch={arch}-smoke served 2 requests, 6 tokens" in \
            capsys.readouterr().out
    for arch in ("mamba2-370m", "recurrentgemma-2b"):
        assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--n-requests", "2", "--max-new", "3"]) == 0
        assert f"arch={arch}-smoke served 2 requests, 6 tokens" in \
            capsys.readouterr().out
