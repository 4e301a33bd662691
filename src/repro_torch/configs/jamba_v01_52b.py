"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, Mamba+attention 1:7 interleave, MoE 16e top-2 on half the layers.
[arXiv:2403.19887]

long_500k RUNS: only 4 attention layers carry a long KV cache (seq-sharded);
the 28 mamba layers keep O(1) recurrent state."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    block_type="jamba",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    attention_every=8,        # 1 attn : 7 mamba
    rope="none",              # jamba attention layers use no positional enc.
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    mamba_chunk=512,
)
