"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared experts.

24L d_model=2048 16H (GQA kv=16) d_ff=1408 (per expert) vocab=151936
[hf:Qwen/Qwen1.5-MoE-A2.7B]. Shared experts are always-on (their joint
hidden dim = 4 x 1408 = 5632).
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151936,
    n_experts=60, n_experts_per_tok=4, moe_d_ff=1408, n_shared_experts=4,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=64, vocab_size=512,
        n_experts=8, n_experts_per_tok=4, moe_d_ff=64, n_shared_experts=2,
        dtype="float32")
