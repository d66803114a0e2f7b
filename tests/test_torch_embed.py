"""The embedding's gradient, bit for bit from run to run on the CPU.

``models.layers.embed_lookup`` is ``table[tokens]`` whose backward adds a
repeated token's rows in token order; the indexing backward it replaces
added them in parallel on the CPU, so a batch with many repeats gave other
bits from run to run, and a resumed CPU training run left the
uninterrupted one.
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch
from _threads import one_thread                          # noqa: F401

from repro_torch.models import layers


def _draw(seed=0, vocab=16, shape=(8, 128), d=64):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, shape),
            rng.standard_normal((vocab, d)).astype(np.float32),
            rng.standard_normal(shape + (d,)).astype(np.float32))


def _grad(tokens, table, g):
    t = torch.from_numpy(table).requires_grad_(True)
    layers.embed_lookup(t, torch.from_numpy(tokens)).backward(
        torch.from_numpy(g))
    return t.grad


def test_embedding_grad_is_bitwise_over_runs_with_threads():
    """8 x 128 tokens from a vocabulary of 16 (each token about 64 times):
    5 backward passes on several threads give one set of bits."""
    tokens, table, g = _draw()
    threads = torch.get_num_threads()
    torch.set_num_threads(max(4, threads))
    try:
        grads = [_grad(tokens, table, g) for _ in range(5)]
    finally:
        torch.set_num_threads(threads)
    assert all(torch.equal(grads[0], x) for x in grads[1:])
    want = np.zeros_like(table, dtype=np.float64)
    np.add.at(want, tokens.reshape(-1), g.reshape(-1, g.shape[-1]))
    np.testing.assert_allclose(grads[0].numpy(), want, rtol=0, atol=1e-4)


def test_embedding_grad_matches_jax():
    """Against ``jax.grad`` of the same lookup, within 1e-6 of max|g|;
    the forward is the same gather, bit for bit."""
    tokens, table, g = _draw(seed=1)
    out = layers.embed_lookup(torch.from_numpy(table),
                              torch.from_numpy(tokens))
    np.testing.assert_array_equal(out.numpy(), table[tokens])

    def f(t):
        return jnp.sum(t[jnp.asarray(tokens)] * jnp.asarray(g))
    want = np.asarray(jax.grad(f)(jnp.asarray(table)))
    got = _grad(tokens, table, g).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_embedding_grad_empty_and_unused_rows():
    """No tokens: a zero gradient; rows no token names stay zero."""
    t = torch.ones(5, 3, requires_grad=True)
    layers.embed_lookup(t, torch.zeros((2, 0), dtype=torch.long)).sum() \
        .backward()
    assert torch.equal(t.grad, torch.zeros(5, 3))
    t.grad = None
    layers.embed_lookup(t, torch.tensor([[1, 1, 3]])).sum().backward()
    assert t.grad[:, 0].tolist() == [0.0, 2.0, 0.0, 1.0, 0.0]


def test_qwen2_moe_launcher_resumes_bitwise_at_default_batch(tmp_path,
                                                             capsys):
    """qwen2-moe's smoke launcher on the CPU at its default 8 x 128
    tokens, resumed from its step-4 checkpoint, gives steps 5-8's losses
    bitwise (before the ordered embedding backward, step 8 differed by
    4.8e-7 in four of seven runs)."""
    from repro_torch.launch import train
    base = ["--arch", "qwen2-moe-a2.7b", "--smoke", "--steps", "8",
            "--device", "cpu", "--log-every", "4"]
    full = tmp_path / "full.json"
    train.main(base + ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every",
                       "4", "--losses-out", str(full)])
    losses = {int(k): v for k, v in json.loads(full.read_text()).items()}
    assert sorted(losses) == list(range(1, 9))
    part = tmp_path / "part"
    part.mkdir()
    (part / "step_00000004.npz").write_bytes(
        (tmp_path / "ck" / "step_00000004.npz").read_bytes())
    (part / "manifest.json").write_text('{"steps": [4]}')
    resumed = tmp_path / "resumed.json"
    train.main(base + ["--ckpt-dir", str(part), "--resume", "--losses-out",
                       str(resumed)])
    assert "resumed from step 4" in capsys.readouterr().out
    got = {int(k): v for k, v in json.loads(resumed.read_text()).items()}
    assert got == {s: losses[s] for s in range(5, 9)}
