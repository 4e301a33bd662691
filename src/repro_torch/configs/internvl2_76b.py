"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — InternViT-6B vision encoder STUB + LLaMA-3-70B-style LM
backbone. [arXiv:2404.16821]

The ViT + MLP projector is the assignment's allowed stub: input_specs
supplies 256 projected patch embeddings (B, 256, 8192) prepended to the text
stream. long_500k via sliding window."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    arch_type="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    vis_tokens=256,
    rope="full",
    rope_theta=500_000.0,
)
