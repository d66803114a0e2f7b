"""musicgen-medium [audio] — decoder-only transformer over EnCodec tokens.

48L d_model=1536 24H (GQA kv=24 = MHA) d_ff=6144 vocab=2048
[arXiv:2306.05284; hf]. The EnCodec/conditioning front end is a stub:
precomputed frame embeddings (``prefix_embeds``, n_prefix_embeds of them)
are prepended to the token stream. GELU FFN (MusicGen uses a standard
transformer FFN); positions via RoPE (a hardware adaptation of the original
sinusoidal embedding).
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="musicgen-medium",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048,
    mlp_type="gelu",
    input_mode="embeds", n_prefix_embeds=64,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=512,
        mlp_type="gelu", input_mode="embeds", n_prefix_embeds=8,
        dtype="float32")
