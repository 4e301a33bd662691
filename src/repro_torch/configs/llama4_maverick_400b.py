"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192,
MoE 128 experts top-1, vocab=202048 — early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E / Maverick model card]

MoE every OTHER layer (interleaved, per the model card): a flat 48x128e
reading gives ~780B params, contradicting the 400B name; with moe_every=2 the
total is ~400B and active ~17B (DESIGN.md §5). Early fusion: the backbone here
is text-only; multimodal tokens would enter through the same embedding
stream. long_500k via sliding window (Llama-4 uses chunked attention on 3/4
of its layers; sliding window is our TPU-equivalent)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    num_experts=128,
    experts_per_token=1,
    moe_every=2,
    rope="full",
    rope_theta=500_000.0,
)
