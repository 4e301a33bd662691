"""whisper-small [audio]: 12L d_model=768 12H (MHA kv=12) d_ff=3072
vocab=51865 — enc-dec, conv/mel frontend STUB (input_specs supplies frame
embeddings (B, 1500, 768)). [arXiv:2212.04356]

12 heads % 16 mesh != 0 -> heads replicate on `model`; FFN/vocab shard.
long_500k skipped (enc-dec audio decoder; DESIGN.md §5)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    arch_type="audio",
    num_layers=12,            # decoder layers (encoder: enc_layers)
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    mlp_act="gelu",
    rope="none",              # whisper uses learned absolute positions
    encdec=True,
    enc_layers=12,
    enc_seq=1500,             # 30 s of audio at 50 Hz post-conv
    max_seq=40_960,           # sized for the decode_32k shape
)
