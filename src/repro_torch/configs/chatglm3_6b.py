"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — 2d RoPE (rotary on half the head dims), GQA. [arXiv:2406.12793]

kv=2 % 16 != 0 -> kv heads replicate on `model`; q heads shard 16-way.
long_500k via sliding window."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    arch_type="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope="half",              # chatglm 2d rope: rotary on half the dims
    rope_theta=10_000.0,
)
