"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155. [hf:ibm-granite/granite-3.0-2b-base]

Vocab 49155 % 16 != 0 -> padded to 49168 for the `model`-axis shard
(sharding.py); logits for padded ids are masked. long_500k via sliding
window."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    arch_type="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    rope="full",
    rope_theta=10_000.0,
    tie_embeddings=False,
)
