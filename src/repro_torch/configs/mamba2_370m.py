"""mamba2-370m [ssm] — attention-free SSD (state-space duality).

48L d_model=1024 d_ff=0 vocab=50280 ssm_state=128 [arXiv:2405.21060].
Pure-SSM blocks carry no separate MLP (mlp_type="none"); expand=2 gives
inner=2048, head_dim=64 -> 32 SSD heads; chunked scan with chunk=256.
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-370m",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    block_pattern=("ssd",), mlp_type="none",
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-smoke",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=512,
        block_pattern=("ssd",), mlp_type="none",
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
        dtype="float32")
