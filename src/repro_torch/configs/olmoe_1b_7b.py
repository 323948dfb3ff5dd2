"""olmoe-1b-7b [moe] 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64e top-8 [arXiv:2409.02060; hf]."""

from repro_torch.models.config import ArchConfig, MoEConfig

ARCH = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304, head_dim=128,
    moe=MoEConfig(num_experts=64, top_k=8, d_expert=1024,
                  norm_topk_prob=True),
)

SMOKE = ArchConfig(
    name="olmoe-1b-7b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=32, vocab_size=512, head_dim=16,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=32,
                  norm_topk_prob=True),
)
