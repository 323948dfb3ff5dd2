"""mistral-nemo-12b [dense] 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407; hf]."""

from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=128,
    qkv_bias=False, rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="mistral-nemo-12b-smoke", family="dense",
    num_layers=3, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=32,
)
