"""Model configuration for the unified LM zoo.

The port's own copy of ``repro.models.config``, field for field (the tests
pin it to the original).

One dataclass covers every assigned architecture: dense transformers
(GQA/MQA + SwiGLU), MoE transformers (Mixtral / Qwen2-MoE), attention-free
SSMs (Mamba2 SSD), hybrids (RecurrentGemma RG-LRU + local attention), and
modality-stub backbones (MusicGen / InternVL2, whose frontends provide
precomputed embeddings per the assignment).

The paper's technique (block-sparse SpMM with InCRS-style prefix-counter
metadata) is a *matmul substrate* and is exposed here as ``BlockSparsity``:
any FFN can be declared block-sparse and routed through the BSR kernel path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BlockSparsity:
    """Block-sparse weight config (the paper's SpMM as a training feature).

    ``block`` is the dense tile size (MXU-aligned, 128 by default) and
    ``density`` the fraction of blocks kept. Metadata per block-row is the
    InCRS prefix-counter analogue (see ``core/bsr.py``).
    """

    block: int = 128
    density: float = 0.25


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                       # 0 -> d_model // n_heads

    # Block layout. ``block_pattern`` repeats to fill n_layers; entries are
    # "attn" | "ssd" | "rglru" | "local_attn". Each block is mixer + MLP
    # unless mlp_type == "none" (pure-SSM blocks carry no separate MLP).
    block_pattern: Tuple[str, ...] = ("attn",)
    mlp_type: str = "swiglu"                # "swiglu" | "gelu" | "none"

    # Attention details.
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None    # None -> full causal
    logits_soft_cap: Optional[float] = None

    # MoE (0 experts -> dense FFN).
    n_experts: int = 0
    n_experts_per_tok: int = 0
    moe_d_ff: int = 0                       # per-expert hidden dim
    n_shared_experts: int = 0               # always-on experts (Qwen2-MoE)
    capacity_factor: float = 1.25

    # Mamba2 SSD.
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4

    # RG-LRU (RecurrentGemma).
    lru_width: int = 0                      # 0 -> d_model
    local_window: int = 2048

    # Modality stub: "tokens" feeds token ids through the embedding table;
    # "embeds" additionally accepts precomputed frontend embeddings
    # (EnCodec frames / ViT patches) prepended to the token stream.
    input_mode: str = "tokens"
    n_prefix_embeds: int = 0                # stub frontend sequence length

    # Numerics.
    dtype: str = "bfloat16"                 # activation/compute dtype
    param_dtype: str = "float32"
    # Rematerialization policy for the layer scan: "nothing" (full remat)
    # or "dots" (save matmul outputs: no recompute of the TP-all-reduced
    # tensors in the backward pass, at higher activation memory).
    remat_policy: str = "nothing"
    flash_chunk: int = 1024                 # flash-attention key-chunk size

    # Paper technique hook: block-sparse FFN weights.
    sparsity: Optional[BlockSparsity] = None

    # Normalization / misc.
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_layers % len(self.block_pattern) != 0:
            raise ValueError(
                f"{self.name}: pattern {self.block_pattern} must tile "
                f"{self.n_layers} layers")
        if self.n_heads and self.n_kv_heads:
            if self.n_heads % self.n_kv_heads != 0:
                raise ValueError(
                    f"{self.name}: n_heads={self.n_heads} must be a "
                    f"multiple of n_kv_heads={self.n_kv_heads}")

    # ------------------------------------------------------------------
    @property
    def n_groups(self) -> int:
        """Scan-over-layers groups (one group = one pattern repetition)."""
        return self.n_layers // len(self.block_pattern)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def lru_dim(self) -> int:
        return self.lru_width or self.d_model

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attention_free(self) -> bool:
        return all(b in ("ssd", "rglru") for b in self.block_pattern)

    @property
    def max_attention_window(self) -> Optional[int]:
        """Upper bound on KV history any attention block needs; None means
        unbounded (full attention somewhere in the pattern)."""
        windows = []
        for b in self.block_pattern:
            if b == "attn":
                if self.sliding_window is None:
                    return None
                windows.append(self.sliding_window)
            elif b == "local_attn":
                windows.append(self.local_window)
        return max(windows) if windows else 0

    @property
    def supports_long_context(self) -> bool:
        """True iff per-token state is O(1) in sequence length (SSM/hybrid/
        windowed attention) — the assignment's long_500k eligibility rule."""
        return self.max_attention_window is not None

    # ------------------------------------------------------------------
    def padded_vocab(self, multiple: int = 2048) -> int:
        """Vocab padded for even model-axis sharding (MaxText-style)."""
        return -(-self.vocab_size // multiple) * multiple

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.padded_vocab()
        total = v * d                       # embedding
        if not self.tie_embeddings:
            total += v * d                  # output head
        hd = self.head_dim
        for blk in self.block_pattern:
            n = self.n_groups
            if blk in ("attn", "local_attn"):
                q = self.n_heads * hd
                kv = self.n_kv_heads * hd
                total += n * (d * q + 2 * d * kv + q * d)
            elif blk == "ssd":
                inner = self.ssm_inner
                nh = self.ssm_heads
                total += n * (d * (2 * inner + 2 * self.ssm_state + nh)
                              + self.conv_width * (inner + 2 * self.ssm_state)
                              + 2 * nh + inner * d)
            elif blk == "rglru":
                w = self.lru_dim
                total += n * (2 * d * w + self.conv_width * w + 2 * w * w
                              + 2 * w + w * d)
            if self.mlp_type != "none":
                nmat = 3 if self.mlp_type == "swiglu" else 2
                if self.is_moe:
                    e, f = self.n_experts, self.moe_d_ff
                    total += n * (d * e + e * 3 * d * f)
                    if self.n_shared_experts:
                        fs = self.n_shared_experts * self.moe_d_ff
                        total += n * 3 * d * fs
                else:
                    total += n * nmat * d * self.d_ff
            total += n * 2 * d              # norms
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed top-k experts)."""
        if not self.is_moe:
            return self.param_count()
        e, k, f, d = (self.n_experts, self.n_experts_per_tok,
                      self.moe_d_ff, self.d_model)
        inactive = self.n_layers * (e - k) * 3 * d * f
        return self.param_count() - inactive
