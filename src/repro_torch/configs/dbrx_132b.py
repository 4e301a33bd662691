"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4, fine-grained. [hf:databricks/dbrx-base]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    arch_type="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    experts_per_token=4,
    moe_every=1,
    rope="full",
    rope_theta=500_000.0,
)
