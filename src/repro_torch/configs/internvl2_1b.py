"""internvl2-1b [vlm] 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT + InternLM2 [arXiv:2404.16821; hf].

The InternViT frontend is a STUB per the assignment: `input_specs()`
provides precomputed patch embeddings [B, num_patches, d_model] that are
prepended to the text embeddings.  The transformer backbone (InternLM2
chat-0.5b shape) is fully modelled.
"""

from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655, head_dim=64,
    qkv_bias=False, rope_theta=1e6, tie_embeddings=True,
    frontend="vit_stub", num_patches=256,
)

SMOKE = ArchConfig(
    name="internvl2-1b-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=16, tie_embeddings=True,
    frontend="vit_stub", num_patches=8,
)
