"""phi3-medium-14b [dense] — RoPE + SwiGLU + GQA.

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352 [arXiv:2404.14219].
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="phi3-medium-14b",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
    d_ff=17920, vocab_size=100352, remat_policy="dots",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab_size=512, dtype="float32")
