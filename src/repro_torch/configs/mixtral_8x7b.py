"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, SWA 4096
[arXiv:2401.04088; hf]. The MoE dispatch is capacity-limited: an
expert's slots are its assigned tokens in sequence order (a prefix count,
the InCRS counter idea at token scale).
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="mixtral-8x7b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    sliding_window=4096, rope_theta=1e6,
    n_experts=8, n_experts_per_tok=2, moe_d_ff=14336,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512,
        sliding_window=16,
        n_experts=4, n_experts_per_tok=2, moe_d_ff=128,
        dtype="float32")
