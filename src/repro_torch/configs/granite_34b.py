"""granite-34b [dense] — code model with MQA (kv=1).

88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152 [arXiv:2405.04324].
Granite Code 34B is GPT-BigCode-style: 2-matrix GELU MLP (that is what
lands the parameter count at ~34B; a SwiGLU MLP would give 47B).
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="granite-34b",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, mlp_type="gelu", remat_policy="dots",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-34b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=256, vocab_size=512, dtype="float32")
