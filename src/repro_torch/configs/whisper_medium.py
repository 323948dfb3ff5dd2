"""whisper-medium [audio] 24L d_model=1024 16H (GQA kv=16) d_ff=4096
vocab=51865 — enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified].

24 encoder + 24 decoder layers; MHA; GELU MLPs; LayerNorm; learned
positions.  The mel-spectrogram conv frontend is a STUB: `input_specs()`
provides the 1500 frame embeddings the conv stack would produce for a 30 s
window.  Decode shapes exercise the decoder with self+cross attention.
"""

from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="whisper-medium", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=51865, head_dim=64,
    encoder_layers=24, encoder_seq=1500, frontend="conv_stub",
)

SMOKE = ArchConfig(
    name="whisper-medium-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512, head_dim=16,
    encoder_layers=2, encoder_seq=32, frontend="conv_stub",
)
