"""deepseek-v2-lite-16b [moe] 27L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64e top-6 — MLA kv_lora=512, 2 shared + 64 routed top-6
[arXiv:2405.04434; hf].

MLA caches only the 512-d compressed latent + 64-d decoupled RoPE key per
token (weight-absorbed decode).  Layer 0 is dense (d_ff 10944); layers
1..26 route over 64 experts (top-6) plus 2 shared experts.
"""

from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig

ARCH = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2,
                  norm_topk_prob=False, first_dense=1, dense_d_ff=10944),
)

SMOKE = ArchConfig(
    name="deepseek-v2-lite-16b-smoke", family="moe",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=48, vocab_size=512,
    mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=48, num_shared=1,
                  norm_topk_prob=False, first_dense=1, dense_d_ff=96),
)
