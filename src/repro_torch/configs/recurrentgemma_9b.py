"""recurrentgemma-9b [hybrid] 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attn, 1:2 [arXiv:2402.19427; unverified].

Block pattern (rglru, rglru, local_attn) — two recurrent blocks per local
(window 2048) MQA attention block, as in Griffin.  Constant-size recurrent
state + bounded attention window -> sub-quadratic: the `long_500k` shape
runs for this architecture.
"""

from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "local_attn"),
    local_window=2048, lru_width=4096, conv1d_width=4,
    tie_embeddings=True, sub_quadratic=True,
)

SMOKE = ArchConfig(
    name="recurrentgemma-9b-smoke", family="hybrid",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=1,
    d_ff=128, vocab_size=512, head_dim=16,
    block_pattern=("rglru", "rglru", "local_attn"),
    local_window=16, lru_width=64, conv1d_width=4,
    tie_embeddings=True, sub_quadratic=True,
)
