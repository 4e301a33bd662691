"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544. [arXiv:2403.17297]

long_500k runs via the sliding-window variant (DESIGN.md §5)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    arch_type="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    rope="full",
    rope_theta=1_000_000.0,
)
