"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks (xLSTM[7:1]: one sLSTM block per 8). [arXiv:2405.04517]

d_ff=0 -> no separate FFN on mLSTM blocks (block-internal projections); the
sLSTM block carries a GELU MLP (pf 4/3 rounding -> d_ff = 2*d). long_500k
RUNS natively (O(1) recurrent state)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    arch_type="ssm",
    block_type="xlstm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=2048,                # sLSTM-block MLP only (cfg d_ff=0 per brief)
    vocab_size=50304,
    rope="none",
    slstm_every=8,
    xlstm_chunk=256,
    mlp_act="gelu",
)
