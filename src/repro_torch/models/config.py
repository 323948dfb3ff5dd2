"""Architecture configuration schema for the model zoo.

One frozen dataclass describes every assigned architecture; the builders in
`repro_torch.models.lm` consume it (a copy of the JAX package's schema,
pure data).  Families:

  dense   — GQA decoder LM (qwen2*, mistral-nemo)
  moe     — mixture-of-experts decoder LM (olmoe, deepseek-v2-lite w/ MLA)
  hybrid  — RG-LRU + local attention (recurrentgemma)
  ssm     — xLSTM (mLSTM + sLSTM blocks)
  audio   — encoder-decoder with stubbed conv frontend (whisper)
  vlm     — decoder LM with stubbed ViT patch embeddings (internvl2)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["MoEConfig", "MLAConfig", "ArchConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                  # hidden width of each routed expert
    num_shared: int = 0            # shared (always-on) experts
    capacity_factor: float = 1.25
    norm_topk_prob: bool = True    # olmoe normalizes; deepseek-v2 does not
    router_dtype: str = "float32"
    first_dense: int = 0           # leading dense layers (deepseek-v2)
    dense_d_ff: int = 0            # FF width of those dense layers


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int = 0           # 0 = full-rank queries (V2-Lite)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # block pattern cycled over layers; entries in
    # {"attn", "local_attn", "rglru", "mlstm", "slstm"}
    block_pattern: Tuple[str, ...] = ("attn",)
    local_window: int = 2048
    lru_width: int = 0             # 0 -> d_model
    conv1d_width: int = 4

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None

    # encoder-decoder (audio family)
    encoder_layers: int = 0
    encoder_seq: int = 0           # fixed encoder length (stub frontend)

    # multimodal stub frontend
    frontend: str = "none"         # none | vit_stub | conv_stub
    num_patches: int = 0           # vlm: patch-embedding prefix length

    # capability flags
    sub_quadratic: bool = False    # constant-memory decode -> long_500k runs

    # ---------------------------------------------------------------- utils
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def pattern_for(self, n_layers: int) -> Tuple[str, ...]:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(n_layers))

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + norms)."""
        d, hd = self.d_model, self.resolved_head_dim
        nh, nkv = self.num_heads, self.num_kv_heads
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb

        def attn_params() -> int:
            if self.mla is not None:
                m = self.mla
                qd = nh * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                p = d * qd                                   # W_q
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)   # W_dkv+W_kr
                p += m.kv_lora_rank * nh * (m.qk_nope_head_dim
                                            + m.v_head_dim)  # W_ukv
                p += nh * m.v_head_dim * d                   # W_o
                return p
            p = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
            if self.qkv_bias:
                p += nh * hd + 2 * nkv * hd
            return p

        def mlp_params(ff: int) -> int:
            # SwiGLU (3 matrices) except the GELU MLPs of the audio family
            return (2 if self.family == "audio" else 3) * d * ff

        def rglru_params() -> int:
            w = self.lru_width or d
            return 2 * d * w + w * d + self.conv1d_width * w + 2 * w

        def mlstm_params() -> int:
            up = 2 * d
            return d * up * 2 + up * d + 3 * up * (up // max(nh, 1)) // max(
                up // max(nh, 1), 1)  # approx q,k,v projections

        for kind in self.pattern_for(self.num_layers):
            if kind in ("attn", "local_attn"):
                total += attn_params()
                if self.moe is not None:
                    m = self.moe
                    total += d * m.num_experts                 # router
                    total += m.num_experts * mlp_params(m.d_expert) // 1
                    if m.num_shared:
                        total += mlp_params(m.d_expert * m.num_shared)
                elif self.d_ff:
                    total += mlp_params(self.d_ff)
            elif kind == "rglru":
                total += rglru_params()
                if self.d_ff:
                    total += mlp_params(self.d_ff)
            elif kind in ("mlstm", "slstm"):
                total += mlstm_params()
        if self.encoder_layers:
            # encoder: self-attn + MLP; decoder layers already counted via
            # the pattern loop get their cross-attention added here
            total += self.encoder_layers * (attn_params()
                                            + mlp_params(self.d_ff))
            total += self.num_layers * attn_params()      # cross-attn
        return total

    def encoder_param_count(self) -> int:
        """Parameters in the encoder stack only (enc-dec FLOP accounting)."""
        if not self.encoder_layers:
            return 0
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d
        mats = 2 if self.family == "audio" else 3
        return self.encoder_layers * (attn + mats * d * self.d_ff)
