"""qwen2.5-32b [dense] 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064 — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf]."""

from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="qwen2.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=27648, vocab_size=152064, head_dim=128,
    qkv_bias=True, rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="qwen2.5-32b-smoke", family="dense",
    num_layers=4, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=16,
    qkv_bias=True,
)
