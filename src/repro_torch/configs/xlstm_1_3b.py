"""xlstm-1.3b [ssm] 48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304 —
sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

7:1 mLSTM:sLSTM block ratio (xLSTM[7:1]).  mLSTM blocks carry a matrix
memory (chunkwise-parallel training form); sLSTM blocks are scalar-memory
recurrences with exponential gating.  d_ff=0: mLSTM blocks embed their own
2x up-projection; sLSTM blocks are followed by a 4/3 gated FF.
Constant-size state -> sub-quadratic -> `long_500k` runs.
"""

from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    sub_quadratic=True,
)

SMOKE = ArchConfig(
    name="xlstm-1.3b-smoke", family="ssm",
    num_layers=8, d_model=64, num_heads=2, num_kv_heads=2,
    d_ff=0, vocab_size=512,
    block_pattern=("mlstm",) * 3 + ("slstm",),
    sub_quadratic=True,
)
