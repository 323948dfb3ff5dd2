"""qwen2.5-3b [dense] 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf]."""

from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
    d_ff=11008, vocab_size=151936, head_dim=128,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="qwen2.5-3b-smoke", family="dense",
    num_layers=3, d_model=96, num_heads=4, num_kv_heads=2,
    d_ff=192, vocab_size=512, head_dim=24,
    qkv_bias=True, tie_embeddings=True,
)
