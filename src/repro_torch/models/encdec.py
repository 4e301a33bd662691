"""Encoder-decoder transformer backbone, whisper-small (counterpart of
repro.models.encdec).

    model = EncDec(cfg, device=..., generator=...)
    enc_out = model.encode(frames)                     # (B, S_enc, d)
    logits, cache = model.decode(tokens, enc_out, cache=..., logits_slice=1)
    loss, aux = loss_fn(cfg, model, batch)

The mel-spectrogram and conv frontend is the reference's stub: `frames`
are precomputed frame embeddings (B, enc_seq, d). The encoder adds the
learned `pos_enc` and runs pre-norm layers of non-causal self-attention
and a GELU MLP, with no rope; the decoder adds `pos_dec` at the token
positions (clipped to max_seq - 1) and runs causal self-attention (k/v
cached for decode), cross-attention to the encoder states (no mask, no
rope, no cache: a decode step attends its one query to every frame) and
the MLP. Every attention product of the encoder, of a prefill's
self-attention and of every cross-attention, decode steps included, runs
through ops.flash_attention (the hand-written kernel on the card); the
cached self-attention of a decode step runs the plain `_decode_attention`,
as in the decoder-only LM. Whisper's LayerNorm is RMSNorm here, as in the
reference. The reference's encoder-decoder never checkpoints its layers
(`cfg.remat` is not read there), and neither does this module.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .attention import Attention, init_cache
from .common import RMSNorm, cross_entropy, init_scale
from .lm import MLP


class EncoderLayer(nn.Module):
    """ln1, attn (non-causal), ln2, mlp."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.mlp = MLP(cfg, dtype, device)

    def forward(self, x, positions, attention=None):
        h, _ = self.attn(self.ln1(x), positions, attention=attention,
                         causal=False)
        x = x + h
        return x + self.mlp(self.ln2(x))


class DecoderLayer(nn.Module):
    """ln1, self_attn (causal, cached), ln_x, cross_attn, ln2, mlp."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.self_attn = Attention(cfg, dtype, device)
        self.ln_x = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.cross_attn = Attention(cfg, dtype, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.mlp = MLP(cfg, dtype, device)

    def forward(self, x, enc_out, positions, cache=None, attention=None):
        """Returns (x, new_cache)."""
        h, new_cache = self.self_attn(self.ln1(x), positions, cache,
                                      attention=attention)
        x = x + h
        h, _ = self.cross_attn(self.ln_x(x), positions, attention=attention,
                               kv_x=enc_out)
        x = x + h
        return x + self.mlp(self.ln2(x)), new_cache


class EncDec(nn.Module):
    """embed, pos_enc, pos_dec, enc_blocks, enc_norm, dec_blocks,
    final_norm, lm_head of the whisper backbone.

    Runs on `cuda` unless `device` says otherwise. Parameters are drawn
    from `generator` with the reference's initializers (0.02 for embed,
    pos_enc and pos_dec, 1 / sqrt(fan_in) for the projections and the
    head, ones for the norms); `init=False` leaves them uninitialized for
    models/convert.py."""

    AXES = {"embed": ("vocab", "embed"), "pos_enc": ("enc_seq", "embed"),
            "pos_dec": ("dec_seq", "embed"), "lm_head": ("embed", "vocab")}

    def __init__(self, cfg, device=None, dtype=torch.float32,
                 generator=None, init: bool = True):
        super().__init__()
        if not cfg.encdec:
            raise ValueError(f"{cfg.name} is not an encoder-decoder")
        device = resolve_device(device)
        self.cfg = cfg
        norope = cfg.with_overrides(rope="none")
        d, V = cfg.d_model, cfg.vocab_size

        def empty(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device))
        self.embed = empty(V, d)
        self.pos_enc = empty(cfg.enc_seq, d)
        self.pos_dec = empty(cfg.max_seq, d)
        self.enc_blocks = nn.ModuleList(
            EncoderLayer(norope, dtype, device)
            for _ in range(cfg.enc_layers))
        self.enc_norm = RMSNorm(d, cfg.norm_eps, dtype, device)
        self.dec_blocks = nn.ModuleList(
            DecoderLayer(norope, dtype, device)
            for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(d, cfg.norm_eps, dtype, device)
        self.lm_head = empty(d, V)
        if init:
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        for w in (self.embed, self.pos_enc, self.pos_dec):
            w.normal_(0.0, init_scale("small_normal", 0),
                      generator=generator)
        for layer in self.enc_blocks:
            layer.attn.reset_parameters(generator)
            layer.mlp.reset_parameters(generator)
        for layer in self.dec_blocks:
            layer.self_attn.reset_parameters(generator)
            layer.cross_attn.reset_parameters(generator)
            layer.mlp.reset_parameters(generator)
        self.lm_head.normal_(0.0, init_scale("normal", self.cfg.d_model),
                             generator=generator)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def encode(self, frames, attention=None):
        """frames (B, S_enc, d) -> encoder states (B, S_enc, d)."""
        B, S, _ = frames.shape
        x = frames.to(self.enc_norm.weight.dtype) + self.pos_enc[None, :S]
        pos = torch.arange(S, device=x.device).expand(B, S)
        for layer in self.enc_blocks:
            x = layer(x, pos, attention)
        return self.enc_norm(x)

    def decode(self, tokens, enc_out, cache=None, positions=None,
               logits_slice: int = 0, attention=None):
        """tokens (B, S); enc_out (B, S_enc, d) -> (logits, new_cache).
        cache: `init_decode_cache`, its k/v written in place; the returned
        cache carries index + S."""
        B, S = tokens.shape
        start = cache["index"] if cache is not None else 0
        if positions is None:
            positions = (start + torch.arange(S, device=tokens.device)) \
                .expand(B, S)
        x = self.embed[tokens].to(enc_out.dtype)
        x = x + self.pos_dec[positions.clamp(0, self.cfg.max_seq - 1)]
        layers = cache["layers"] if cache is not None else \
            [None] * len(self.dec_blocks)
        new_layers = []
        for layer, layer_cache in zip(self.dec_blocks, layers):
            x, c = layer(x, enc_out, positions, layer_cache, attention)
            new_layers.append(c)
        x = self.final_norm(x)
        if logits_slice:
            x = x[:, -logits_slice:]
        logits = x @ self.lm_head
        new_cache = ({"layers": new_layers, "index": start + S}
                     if cache is not None else None)
        return logits, new_cache

    def forward(self, frames, tokens, attention=None):
        """The training forward: decode(tokens, encode(frames)) logits."""
        return self.decode(tokens, self.encode(frames, attention),
                           attention=attention)[0]

    def init_decode_cache(self, batch: int, max_len: int):
        """`init_decode_cache(cfg, ...)` in the parameters' dtype, on their
        device."""
        return init_decode_cache(self.cfg, batch, max_len, self.embed.dtype,
                                 self.device)


def init_decode_cache(cfg, batch: int, max_len: int, dtype=torch.float32,
                      device=None):
    """Zeroed k/v caches (B, max_len, KH, hd) of the decoder's
    self-attention layers in `dtype`, index 0."""
    return {"layers": [init_cache(cfg, batch, max_len, dtype, device)
                       for _ in range(cfg.num_layers)], "index": 0}


def cache_axes(cfg) -> dict:
    """Logical axes mirroring `init_decode_cache` (the reference's
    `cache_axes` without its stacking "layers" axis)."""
    attn = {"k": ("batch", "kv_seq", "kv_heads", "head_dim"),
            "v": ("batch", "kv_seq", "kv_heads", "head_dim"),
            "index": ()}
    return {"layers": [attn] * cfg.num_layers, "index": ()}


def loss_fn(cfg, model, batch, aux_weight: float = 0.0, attention=None):
    """(loss, {"ce", "aux"}) on batch = dict(frames (B, S_enc, d), tokens
    (B, S), labels (B, S)): the reference's `encdec.loss_fn`, aux 0."""
    logits = model(batch["frames"], batch["tokens"], attention=attention)
    ce = cross_entropy(logits, batch["labels"])
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=ce.device)}


def param_count(cfg) -> int:
    """Parameters of the encoder-decoder of `cfg`."""
    d, H, KH, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    attn = d * hd * (2 * H + 2 * KH)
    mlp = (3 if cfg.mlp_act == "swiglu" else 2) * d * cfg.d_ff
    enc = cfg.enc_layers * (2 * d + attn + mlp)
    dec = cfg.num_layers * (3 * d + 2 * attn + mlp)
    return (2 * cfg.vocab_size * d + (cfg.enc_seq + cfg.max_seq) * d
            + enc + dec + 2 * d)
