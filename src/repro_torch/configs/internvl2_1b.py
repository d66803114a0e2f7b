"""internvl2-1b [vlm] — InternLM2 LM backbone; InternViT frontend stubbed.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655 [arXiv:2404.16821].
ViT patch embeddings arrive precomputed as ``prefix_embeds`` (256 patches,
the modality stub).
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="internvl2-1b",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151655,
    input_mode="embeds", n_prefix_embeds=256,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab_size=512,
        input_mode="embeds", n_prefix_embeds=16,
        dtype="float32")
