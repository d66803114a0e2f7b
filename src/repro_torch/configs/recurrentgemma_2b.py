"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, ~1:2 ratio.

26L d_model=2560 10H (MQA kv=1, head_dim=256) d_ff=7680 vocab=256000
[arXiv:2402.19427]. The reference model repeats (rec, rec, attn); 26 is not
divisible by 3, so we tile a 13-block pattern twice (9 recurrent + 4 local-
attention per repetition -> 18:8 overall, the same 1:2.25 ratio as the
released checkpoint's 18 recurrent / 8 attention blocks). Local window 2048.
"""
from ..models.config import ModelConfig

_PATTERN13 = ("rglru", "rglru", "local_attn") * 4 + ("rglru",)

FULL = ModelConfig(
    name="recurrentgemma-2b",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000,
    block_pattern=_PATTERN13,
    lru_width=2560, local_window=2048,
    logits_soft_cap=30.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=256, vocab_size=512,
        block_pattern=("rglru", "rglru", "local_attn"),
        lru_width=64, local_window=16, logits_soft_cap=30.0,
        dtype="float32")
