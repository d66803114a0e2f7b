"""llama3-405b [dense] — GQA, 128k padded vocab.

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256
[arXiv:2407.21783]. RoPE theta 500k per the paper.
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="llama3-405b",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab_size=128256, rope_theta=500000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b-smoke",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab_size=512, dtype="float32")
