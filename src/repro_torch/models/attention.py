"""Multi-head / grouped-query attention with RoPE, KV cache, sliding window
(counterpart of repro.models.attention).

Layout: activations (B, S, d); q/k/v (B, S, H|KH, hd); the weights keep the
reference's layout, wq (d, H, hd), wk and wv (d, KH, hd), wo (H, hd, d).
The attention inner product of a prefill, a forward pass or a
cross-attention (k and v from `kv_x`, every source position admitted,
decode steps included) runs through kernels/ops.flash_attention (the
hand-written CUDA kernel on the card, its plain version on the CPU).
Cached decode (Sq == 1 with a cache) runs the plain
`_decode_attention` over the whole cache, as the reference does: it is a
GEMV over the cache, not a kernel of the reference.
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels import ops
from .common import apply_rope, init_scale, rope_freqs


class Attention(nn.Module):
    """wq, wk, wv, wo of one attention layer."""

    AXES = {"wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed_out")}

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        d, H, KH = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        hd = cfg.resolved_head_dim

        def empty(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device))
        self.wq = empty(d, H, hd)
        self.wk = empty(d, KH, hd)
        self.wv = empty(d, KH, hd)
        self.wo = empty(H, hd, d)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The reference's initial scales: 1 / sqrt(d) for wq, wk, wv and
        1 / sqrt(H) for wo (the fan-in axis of every ParamDef is its
        first)."""
        for w in (self.wq, self.wk, self.wv, self.wo):
            w.normal_(0.0, init_scale("normal", w.shape[0]),
                      generator=generator)

    def forward(self, x, positions, cache=None, attention=None,
                causal: bool = True, kv_x=None):
        """Returns (out (B, S, d), new_cache).

        cache: dict(k, v (B, S_max, KH, hd), index int) for autoregressive
        decode; its k and v are written in place at [index, index + S) and
        the returned dict carries index + S. kv_x (B, S_kv, d): the
        cross-attention source (encoder states), from which k and v are
        projected; it takes no rope and no mask (every query sees every
        source position) and is never cached, as in the reference.
        `causal=False` drops the causal mask of self-attention (the
        encoder). `attention` replaces ops.flash_attention (same
        signature) for the prefill and forward products, e.g. with the
        kernel's plain version."""
        B, S, _ = x.shape
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        src = x if kv_x is None else kv_x
        q = torch.einsum("bsd,dhk->bshk", x, self.wq)
        k = torch.einsum("bsd,dhk->bshk", src, self.wk)
        v = torch.einsum("bsd,dhk->bshk", src, self.wv)

        if cfg.rope != "none" and kv_x is None:
            frac = 0.5 if cfg.rope == "half" else 1.0
            cos, sin, rot = rope_freqs(hd, positions, cfg.rope_theta, frac)
            q = apply_rope(q, cos, sin, rot)
            k = apply_rope(k, cos, sin, rot)

        new_cache = None
        if cache is not None:
            idx = cache["index"]
            cache["k"][:, idx:idx + S] = k.to(cache["k"].dtype)
            cache["v"][:, idx:idx + S] = v.to(cache["v"].dtype)
            new_cache = {"k": cache["k"], "v": cache["v"], "index": idx + S}
            if S == 1:
                # decode: attend over the whole (masked) cache
                k, v = cache["k"], cache["v"]
            # prefill (S > 1, index 0): attend over the freshly computed
            # k/v; the padded cache tail would break right-aligned masking

        qt = q.transpose(1, 2)
        kt = k.transpose(1, 2)
        vt = v.transpose(1, 2)
        window = cfg.window or None
        if cache is not None and S == 1:
            out = _decode_attention(qt, kt, vt, cache["index"], window)
        else:
            out = (attention or ops.flash_attention)(
                qt, kt, vt, causal=causal and kv_x is None, window=window)
        out = out.transpose(1, 2)                   # (B, S, H, hd)
        return torch.einsum("bshk,hkd->bsd", out, self.wo), new_cache


def _decode_attention(q, k, v, valid_len: int, window):
    """Single-token decode over the cache, plain PyTorch.

    q (B, H, 1, hd); k/v (B, KH, Smax, hd). Masks positions > valid_len
    (the new token was just written at `valid_len`) and, with a window,
    positions <= valid_len - window. Computes in float32 and returns q's
    dtype."""
    B, H, _, hd = q.shape
    KH, S = k.shape[1], k.shape[2]
    g = H // KH
    qg = q.reshape(B, KH, g, hd).to(torch.float32)
    scores = torch.einsum("bkgd,bksd->bkgs", qg,
                          k.to(torch.float32)) / (hd ** 0.5)
    pos = torch.arange(S, device=q.device)
    mask = pos <= valid_len
    if window:
        mask &= pos > valid_len - window
    scores = scores.masked_fill(~mask, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", w, v.to(torch.float32))
    return out.reshape(B, H, 1, hd).to(q.dtype)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.float32,
               device=None):
    KH, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {"k": torch.zeros((batch, max_len, KH, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, KH, hd), dtype=dtype,
                             device=device),
            "index": 0}
