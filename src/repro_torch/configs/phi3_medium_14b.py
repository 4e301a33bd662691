"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 — RoPE SwiGLU GQA. [arXiv:2404.14219]

40 q-heads / 10 kv-heads % 16 != 0 -> heads replicate on `model` and the
projections FSDP-shard on `data` via the embed axis; FFN/vocab shard on
`model`. long_500k via sliding window."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    rope="full",
    rope_theta=10_000.0,
)
