"""Architecture configuration: a single dataclass covers the 6 assigned
architecture families (dense / moe / ssm / hybrid / audio / vlm).

A copy of the reference's `repro.models.config.ArchConfig`, field for
field, so a configuration means the same in both packages. The port's
models run every family (models/lm.py: dense, MoE, jamba, xLSTM, the
VLM prefix; models/encdec.py: whisper); `use_pallas` is
kept and ignored (a tensor's device decides whether attention runs the
CUDA kernel or its plain version); `remat` and `remat_policy` checkpoint
each block in training (models/lm.py)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1             # MoE FFN every k-th layer (1 = every layer)
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 512      # GShard dispatch group size (tokens)

    # attention
    rope: str = "full"             # full | half | none  (half = chatglm 2d-rope)
    rope_theta: float = 10_000.0
    window: int = 0                # 0 = full causal; >0 = sliding window
    attention_every: int = 1       # hybrid (jamba): attn layer every k-th layer

    # block family
    block_type: str = "transformer"  # transformer | jamba | xlstm
    mlp_act: str = "swiglu"          # swiglu | gelu
    qkv_bias: bool = False

    # mamba (jamba)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_chunk: int = 512

    # xlstm
    slstm_every: int = 8           # every k-th block is sLSTM (rest mLSTM)
    xlstm_chunk: int = 256

    # encoder-decoder (whisper)
    encdec: bool = False
    enc_layers: int = 0
    enc_seq: int = 0               # stub frontend frames (whisper: 1500)

    # vlm
    vis_tokens: int = 0            # stub ViT patch embeddings prepended

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq: int = 8192            # position-emb table size where applicable

    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    use_pallas: bool = False       # ignored by the port (device decides)
    remat: bool = False            # activation checkpoint each block
    remat_policy: str = "full"     # full | dots (save matmul outputs)

    def with_overrides(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner_mamba(self) -> int:
        return self.mamba_expand * self.d_model

    def reduced(self, layers: int = 2, d_model: int = 256,
                experts: int = 4) -> "ArchConfig":
        """Smoke-test variant: same family, tiny dims (spec: 2 layers,
        d_model<=512, <=4 experts)."""
        heads = max(2, min(self.num_heads, d_model // 64))
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        return self.with_overrides(
            name=self.name + "-smoke",
            num_layers=layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d_model // heads,
            d_ff=0 if self.d_ff == 0 else d_model * 2,
            vocab_size=512,
            num_experts=min(self.num_experts, experts) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token else 0,
            enc_layers=min(self.enc_layers, layers),
            enc_seq=min(self.enc_seq, 32) if self.enc_seq else 0,
            vis_tokens=min(self.vis_tokens, 8) if self.vis_tokens else 0,
            moe_group_size=32,
            mamba_chunk=16,
            xlstm_chunk=16,
            slstm_every=min(self.slstm_every, layers),
            attention_every=min(self.attention_every, layers),
            max_seq=256,
            window=min(self.window, 32) if self.window else 0,
        )
