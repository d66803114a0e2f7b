"""JAX's serve overrides on CPU meshes against the port's one-device LM, in
float64: a context-parallel KV cache (``cache_seq`` over "model": each
coordinate holds a span of the ring buffer's slots for every kv head) and
sequence-parallel attention (``attn_q_seq`` over "model": each coordinate
attends a span of the queries, the flash kernel at ``q_offset``), each
alone and both, on the (data 2, model 4) mesh.

Cases: phi3-medium-14b's smoke config (4 heads on 2 kv heads),
granite-34b's (one kv head), internvl2-1b's (16 prefix embeddings),
recurrentgemma-2b's (a local window of 16 slots: a ring buffer smaller
than the prompt), phi3 with a sliding window of 8, and an ``alloc`` that
the model axis does not divide (the cache replicates its slots, as
``resolve`` says, and the head path runs). The long branch (the flash
kernel; ``_flash_attention`` in train mode) is reached by lowering
``layers.FLASH_THRESHOLD`` with ``monkeypatch``.

Bounds: the prefill's logits within 1e-12 of max|logit| (the spans'
products are the one-device rows: bitwise here); a decode step against a
context-parallel cache within 1e-6 (both softmaxes are formed in f32, as
JAX's decode does, and the cache's partial sums merge over the slots in
another order than one softmax sums them); the sharded train step under
``attn_q_seq`` as ``tests/test_torch_lm_sharded.py`` holds steps (1e-6 of
max|g|: attention's f32 scores, k and v's gradients summed over the
spans). Every run's collectives equal the meta run's, kind by kind, to
the byte. And the flash kernel's plain version at ``q_offset`` k equals
the whole sequence's rows [k, Sq + k), bit for bit.
"""
from __future__ import annotations

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401
import torch
from _sharded_lm import batch, cfg_of, init, mesh, rel, step_errors

from repro_torch.kernels import flash_attention as F
from repro_torch.launch import specs
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import spmd
from repro_torch.train.zero import FSDP_OVERRIDES

CP = {"cache_seq": "model"}
SP = {"attn_q_seq": "model"}
BOTH = {**CP, **SP}
RULES = {"cache_seq": CP, "attn_q_seq": SP, "both": BOTH}
PREFILL_TOL = 1e-12
DECODE_TOL = 1e-6
F32_TOL = 1e-5


def _serve(cfg, rules, *, b=2, s=20, steps=4, shape=(2, 4)):
    """A prefill of ``s`` positions then ``steps`` decode steps on one
    device and sharded under ``rules``: the logits' errors / max|logit|,
    the sharded cache and the mesh."""
    model = init(cfg)
    mh = mesh(shape)
    sm = spmd.shard_model(model, mh, rules)
    rng = np.random.default_rng(5)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)))
    pfx, npfx = None, 0
    if cfg.input_mode == "embeds":
        npfx = cfg.n_prefix_embeds
        pfx = torch.as_tensor(rng.normal(size=(b, npfx, cfg.d_model)))
    alloc = npfx + s + steps
    dt = getattr(torch, cfg.dtype)
    l1, c1 = M.prefill_step(model, tok, prefix_embeds=pfx, alloc_seq=alloc,
                            cache_dtype=dt)
    mh.reset_collectives()
    l2, c2 = M.prefill_step(sm, tok, prefix_embeds=pfx, alloc_seq=alloc,
                            cache_dtype=dt)
    errs = [rel(l2.full(), l1)]
    _same_caches(c1, c2, PREFILL_TOL if dt == torch.float64 else F32_TOL)
    for t in range(steps):
        nt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, 1)))
        l1, c1 = M.decode_step(model, nt, c1, pos=npfx + s + t)
        l2, c2 = M.decode_step(sm, nt, c2, pos=npfx + s + t)
        errs.append(rel(l2.full(), l1))
    _same_caches(c1, c2, DECODE_TOL if dt == torch.float64 else F32_TOL)
    return errs, c2, mh


def _same_caches(one, sharded, tol):
    """Each attention layer's gathered cache within ``tol`` of one
    device's, at the same ``end``."""
    for a, b in zip(one, sharded):
        if "k" in a:
            for k in ("k", "v"):
                assert rel(b[k].full(), a[k]) <= tol, k
            assert b["end"] == a["end"]


def _meta_counts(cfg, rules, b, s, steps, shape=(2, 4)):
    """The collectives of the same prefill and decode steps on a meta mesh
    (coordinate 0 alone: the dry run's count)."""
    mh = Mesh(np.full(shape, "meta", dtype=object), ("data", "model"))
    sm = spmd.shard_model(M.Model(cfg, device=specs.META), mh, rules)
    npfx = cfg.n_prefix_embeds if cfg.input_mode == "embeds" else 0
    pfx = None if not npfx else torch.empty(
        (b, npfx, cfg.d_model), dtype=getattr(torch, cfg.dtype),
        device=specs.META)
    alloc = npfx + s + steps
    mh.reset_collectives()
    _, cache = M.prefill_step(sm, torch.empty((b, s), dtype=torch.long,
                                              device=specs.META),
                              prefix_embeds=pfx, alloc_seq=alloc,
                              cache_dtype=getattr(torch, cfg.dtype))
    for t in range(steps):
        _, cache = M.decode_step(sm, torch.empty((b, 1), dtype=torch.long,
                                                 device=specs.META), cache,
                                 pos=npfx + s + t)
    return mh.collectives


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("arch", ["phi3-medium-14b", "granite-34b",
                                  "internvl2-1b", "recurrentgemma-2b"])
def test_serve_overrides_match_one_device(arch, rules):
    cfg = cfg_of(arch)
    errs, cache, mh = _serve(cfg, RULES[rules])
    assert errs[0] < PREFILL_TOL, errs
    assert max(errs[1:]) < DECODE_TOL, errs
    attn = next(c for c in cache if "k" in c)
    assert (attn["k"].spec[1] == "model") == ("cache_seq" in RULES[rules])
    assert mh.collectives == _meta_counts(cfg, RULES[rules], 2, 20, 4)
    if "attn_q_seq" in RULES[rules]:
        assert mh.collectives["all-to-all"]["count"] > 0


def test_sliding_window_and_a_ring_smaller_than_the_prompt():
    """phi3 with a sliding window of 8 (its cache 8 slots, 2 a coordinate)
    and recurrentgemma's local window of 16: prompts of 20 and 36
    positions overrun the ring, decode wraps it."""
    for cfg, s in ((cfg_of("phi3-medium-14b", sliding_window=8), 20),
                   (cfg_of("recurrentgemma-2b"), 36)):
        errs, cache, _ = _serve(cfg, BOTH, s=s, steps=6)
        assert errs[0] < PREFILL_TOL and max(errs[1:]) < DECODE_TOL, errs
        attn = next(c for c in cache if "k" in c)
        assert attn["k"].shape[1] < s and attn["k"].spec[1] == "model"


def test_an_alloc_the_mesh_does_not_divide_replicates():
    """22 slots on 4 model coordinates: ``cache_seq`` resolves to nothing,
    the kv heads shard instead and the head path serves."""
    cfg = cfg_of("phi3-medium-14b")
    errs, cache, _ = _serve(cfg, BOTH, s=20, steps=2)
    assert cache[0]["k"].spec[1] is None
    assert max(errs) < DECODE_TOL, errs


@pytest.mark.parametrize("rules", RULES)
def test_long_branch_runs_flash_once_a_coordinate_at_its_offset(
        monkeypatch, rules):
    """The long branch (``FLASH_THRESHOLD`` lowered to 64 positions, the
    flash chunk 16): under ``attn_q_seq`` each coordinate's span of 16
    queries runs the flash path once a layer at ``q_offset`` 16 j, every
    query head, keys [0, the span's end) cut at a chunk's edge; 8 x 2
    calls. In f32, which the kernels take (the meta run plans the launch):
    the prefill and decode within 1e-5 of max|logit|
    (``tests/test_torch_lm_sharded.py``'s f32 bound)."""
    monkeypatch.setattr(L, "FLASH_THRESHOLD", 64)
    cfg = cfg_of("phi3-medium-14b", "float32", flash_chunk=16)
    real, calls = L.ops.flash_mha, []

    def counted(q, k, v, **kw):
        calls.append((tuple(q.shape), k.shape[1], kw.get("q_offset", 0)))
        return real(q, k, v, **kw)
    monkeypatch.setattr(L.ops, "flash_mha", counted)
    errs, _, mh = _serve(cfg, RULES[rules], s=64, steps=4)
    assert max(errs) < F32_TOL, errs
    sharded = calls[cfg.n_layers:]           # after the one-device run's
    assert len(sharded) == 8 * cfg.n_layers
    if "attn_q_seq" in RULES[rules]:
        assert {c[2] for c in sharded} == {0, 16, 32, 48}
        assert all(c[0] == (1, 16, 2, 2, 16) and c[1] == c[2] + 16
                   for c in sharded)
    else:
        assert {c[2] for c in sharded} == {0}
    assert mh.collectives == _meta_counts(cfg, RULES[rules], 2, 64, 4)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("long", [False, True])
def test_train_step_under_attn_q_seq(monkeypatch, fsdp, long):
    """A sharded train step under ``attn_q_seq`` (internvl2-1b's train
    override, with FSDP or without), the gradients flowing back through
    the all-to-alls; ``long``: ``_flash_attention`` on the span's
    positions (``FLASH_THRESHOLD`` lowered to 32)."""
    if long:
        monkeypatch.setattr(L, "FLASH_THRESHOLD", 32)
    cfg = cfg_of("phi3-medium-14b", flash_chunk=8)
    rules = dict(SP, **(FSDP_OVERRIDES if fsdp else {}))
    lerr, gerr, merr, sm = step_errors(init(cfg), batch(cfg, 8, 32), (2, 4),
                                       rules)
    assert lerr < 1e-6 and gerr < 1e-6 and merr < 1e-6, (lerr, gerr, merr)
    assert sm.mesh.collectives["all-to-all"]["count"] > 0


@pytest.mark.parametrize("window,cap", [(None, None), (40, None),
                                        (None, 30.0), (40, 30.0)])
@pytest.mark.parametrize("off,sq", [(0, 37), (1, 100), (63, 1), (200, 100)])
def test_plain_flash_offset_is_the_whole_sequence_rows(window, cap, off,
                                                       sq):
    """``plain(q_offset=k)`` on rows [k, Sq + k) of q and the whole
    sequence's keys equals ``plain`` on the whole sequence, sliced to those
    rows, bit for bit."""
    gen = torch.Generator().manual_seed(off + sq)
    q = torch.randn((2, 300, 2, 3, 16), generator=gen)
    k = torch.randn((2, 300, 2, 16), generator=gen)
    v = torch.randn((2, 300, 2, 16), generator=gen)
    whole = F.plain(q, k, v, window=window, soft_cap=cap, chunk=64)
    got = F.plain(q[:, off:off + sq], k, v, window=window, soft_cap=cap,
                  chunk=64, q_offset=off)
    assert torch.equal(got, whole[:, off:off + sq])
    with pytest.raises(ValueError, match="q_offset"):
        F.plain(q, k, v, q_offset=-1)
