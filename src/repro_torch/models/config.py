"""Unified model configuration for the 10 assigned architectures.

One dataclass covers the whole zoo; family-specific fields are ignored by
families that do not use them. ``kind`` selects the stack:

  decoder  — dense decoder-only LM (GQA + rotary + SwiGLU; optional QKV bias)
  encdec   — encoder-decoder (seamless backbone; audio frontend stubbed)
  moe      — decoder with routed-expert FFN (optional shared experts)
  ssm      — attention-free Mamba-2 (SSD) stack
  hybrid   — Hymba-style parallel attention + SSM heads per layer
  vlm      — decoder LM consuming a stub patch-embedding prefix

A copy of the reference's dataclass. The port builds every kind
(``models/api.py``).
"""

from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str                  # decoder | encdec | moe | ssm | hybrid | vlm
    n_layers: int
    d_model: int
    n_heads: int               # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention
    head_dim: int = 0          # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: int = 0            # 0 = full causal; >0 = sliding window

    # encoder-decoder
    n_enc_layers: int = 0
    frontend: str | None = None   # "audio" | "vision" (stub frontends)
    frontend_len: int = 0         # frames/patches emitted by the stub

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0          # per-expert FFN width (fine-grained MoE)
    capacity_factor: float = 1.25

    # SSM (Mamba-2 SSD)
    d_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (Hymba)
    n_meta_tokens: int = 0
    ssm_ratio: float = 0.5     # fraction of layer width carried by SSM heads

    # MoE dispatch grouping (1 = global dispatch; >1 = data-local groups,
    # keeping routing gathers/scatters shard-local — see §Perf)
    moe_groups: int = 1

    # training
    dtype: str = "bfloat16"
    remat: bool = True
    tie_embeddings: bool = False
    # sequences >= this use blockwise attention in the reference's XLA
    # path; the port's prefill attention goes through the flash kernel (its
    # plain version on the CPU) at every length, so it does not read this.
    flash_threshold: int = 8192

    def __post_init__(self):
        if self.kind in ("decoder", "encdec", "moe", "hybrid", "vlm"):
            assert self.n_heads > 0 and self.n_kv_heads > 0
            assert self.n_heads % self.n_kv_heads == 0
        if self.kind == "moe":
            assert self.n_experts > 0 and self.top_k > 0 and self.d_expert > 0
        if self.kind in ("ssm", "hybrid"):
            assert self.d_state > 0

    @property
    def dh(self) -> int:
        """Attention head dim."""
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner_ssm // self.ssm_head_dim

    @property
    def params_dense(self) -> int:
        """Approximate parameter count (reported in DESIGN.md; the exact
        count comes from the initialized tree)."""
        D, V, L = self.d_model, self.vocab, self.n_layers
        emb = V * D * (1 if self.tie_embeddings else 2)
        if self.kind == "ssm":
            per = 2 * D * self.d_inner_ssm + self.d_inner_ssm * (
                2 * self.d_state + 3)
            return emb + L * per
        attn = D * (self.n_heads + 2 * self.n_kv_heads) * self.dh + \
            self.n_heads * self.dh * D
        if self.kind == "moe":
            ffn = 3 * D * self.d_expert * (self.n_experts +
                                           self.n_shared_experts) + \
                D * self.n_experts
        else:
            ffn = 3 * D * self.d_ff
        return emb + L * (attn + ffn)

    @property
    def active_params(self) -> int:
        """Active parameters per token (MoE: routed top-k + shared only)."""
        if self.kind != "moe":
            return self.params_dense
        D, L = self.d_model, self.n_layers
        emb = self.vocab * D * (1 if self.tie_embeddings else 2)
        attn = D * (self.n_heads + 2 * self.n_kv_heads) * self.dh + \
            self.n_heads * self.dh * D
        ffn = 3 * D * self.d_expert * (self.top_k + self.n_shared_experts) + \
            D * self.n_experts
        return emb + L * (attn + ffn)
