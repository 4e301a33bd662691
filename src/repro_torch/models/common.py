"""Shared model components: norms, RoPE, MLPs, the token cross-entropy
(counterpart of repro.models.common).

The reference's ParamDef DSL (shapes, logical axes, initializers) maps
parameters to mesh axes; the port keeps parameters in `nn.Module`s, draws
them with the same initial scales (`init_scale`), and each module names
its parameters' logical axes in a class dict `AXES` (`lm.param_axes`).
"""
from __future__ import annotations

import torch
from torch import nn


def init_scale(kind: str, fan_in: int) -> float:
    """Standard deviation of the reference's `init_param`: 0.02 for
    `small_normal` (the embedding), 1 / sqrt(fan_in) for `normal`, where
    fan_in is the size of the parameter's first axis before any stacking
    (`ParamDef.scale_axis`)."""
    if kind == "small_normal":
        return 0.02
    return (1.0 / max(fan_in, 1)) ** 0.5


def rmsnorm(x, w, eps: float = 1e-5):
    """x / rms(x) * w, computed in float32 and cast back to x's dtype."""
    x32 = x.to(torch.float32)
    x32 = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * w.to(torch.float32)).to(x.dtype)


class RMSNorm(nn.Module):
    """RMS norm with a learned scale, initialized to ones."""

    AXES = {"weight": ("embed_norm",)}

    def __init__(self, d: int, eps: float = 1e-5, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, dtype=dtype, device=device))

    def forward(self, x):
        return rmsnorm(x, self.weight, self.eps)


def rope_freqs(head_dim: int, positions, theta: float = 10_000.0,
               fraction: float = 1.0):
    """cos/sin tables (..., S, rot/2) for integer positions (..., S).
    fraction=0.5 -> rotary on half the dims (chatglm 2d)."""
    rot = int(head_dim * fraction)
    exps = torch.arange(0, rot, 2, dtype=torch.float32,
                        device=positions.device) / rot
    inv = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang), rot


def apply_rope(x, cos, sin, rot: int):
    """x (..., S, H, hd); cos/sin (..., S, rot/2) broadcast over heads.

    Rotates interleaved pairs (x[..., 0::2], x[..., 1::2]) of the first
    `rot` dims, as the reference does (not the rotate-half layout)."""
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    c = cos[..., None, :]
    s = sin[..., None, :]
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    if rot < x.shape[-1]:
        out = torch.cat([out, xp], dim=-1)
    return out.to(x.dtype)


def gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


def swiglu(x, wg, wu, wd):
    h = torch.nn.functional.silu(x @ wg) * (x @ wu)
    return h @ wd


def gelu_mlp(x, w1, w2):
    return gelu(x @ w1) @ w2


def cross_entropy(logits, labels, mask=None):
    """Mean token cross-entropy in float32 over the positions whose label
    is >= 0 (and, with `mask`, whose mask is > 0): logits (..., V), labels
    (...) int. Returns a 0-d float32 tensor; 0 when no position counts."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      labels.clamp(min=0).to(torch.int64)[..., None])[..., 0]
    valid = labels >= 0
    if mask is not None:
        valid = valid & (mask > 0)
    nll = (lse - ll) * valid
    return nll.sum() / valid.sum().clamp(min=1)
