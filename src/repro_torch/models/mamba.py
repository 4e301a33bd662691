"""Mamba (S6) layer of the jamba hybrid: the counterpart of
repro.models.mamba.

    out, state = mamba_layer(m, x, cfg, state=None)   # x (B, S, d)

in_proj splits x into u and the gate z (B, S, di); u runs through a
depthwise causal conv of width dc (its last dc - 1 inputs are the
decode state `conv`) and silu; x_proj gives the low-rank dt, B and C;
dt = softplus(dt_low dt_proj + dt_bias); A = -exp(A_log) in float32; the
selective scan h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t, y_t = C_t . h_t;
then (y + u D) silu(z) out_proj.

The scan runs chunk by chunk (`cfg.mamba_chunk` tokens, or the whole
sequence as one chunk when the chunk does not divide it, and on meta
tensors: the dry run's shape-only path, where one chunk has the same
products and FLOPs and S / L times fewer dispatches), each chunk cast
to float32 as the reference casts it, the state h (B, di, ds) float32
carried from chunk to chunk. Within a chunk the reference's
`jax.lax.associative_scan` has no PyTorch counterpart: here a log-step
(Hillis-Steele) scan over the chunk's axis computes the same recurrence
with the same combine, (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2), in
another association order, so the two agree to float32 rounding, not
bit for bit. A decode step (S = 1) updates h once, in the promoted dtype
of dt and A as in the reference (float32 for a bf16 model, float64 for a
float64 one).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as Fn

from .common import init_scale


class Mamba(nn.Module):
    """in_proj, conv_w, conv_b, x_proj, dt_proj, dt_bias, A_log, D,
    out_proj of one mamba layer, in the reference's shapes."""

    AXES = {"in_proj": ("embed", "mamba_inner2"),
            "conv_w": ("conv_k", "mamba_inner"),
            "conv_b": ("mamba_inner",),
            "x_proj": ("mamba_inner", "mamba_low"),
            "dt_proj": ("mamba_low_r", "mamba_inner"),
            "dt_bias": ("mamba_inner",),
            "A_log": ("mamba_inner", "mamba_state"),
            "D": ("mamba_inner",),
            "out_proj": ("mamba_inner", "embed_out")}

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        d, di = cfg.d_model, cfg.d_inner_mamba
        ds, dc = cfg.mamba_d_state, cfg.mamba_d_conv
        dt_rank = max(d // 16, 1)
        shapes = {"in_proj": (d, 2 * di), "conv_w": (dc, di),
                  "conv_b": (di,), "x_proj": (di, dt_rank + 2 * ds),
                  "dt_proj": (dt_rank, di), "dt_bias": (di,),
                  "A_log": (di, ds), "D": (di,), "out_proj": (di, d)}
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device)))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The reference's initializers: zeros for conv_b and dt_bias,
        ones for D, 0.02 for A_log (`small_normal`), 1 / sqrt(fan_in)
        (the first axis) for the projections and conv_w."""
        self.conv_b.zero_()
        self.dt_bias.zero_()
        self.D.fill_(1.0)
        self.A_log.normal_(0.0, init_scale("small_normal", 0),
                           generator=generator)
        for w in (self.in_proj, self.conv_w, self.x_proj, self.dt_proj,
                  self.out_proj):
            w.normal_(0.0, init_scale("normal", w.shape[0]),
                      generator=generator)

    def forward(self, x, state=None):
        return mamba_layer(self, x, self.cfg, state=state)


def _scan_chunk(u, dt, B_in, C_in, A, h0):
    """Selective scan over one float32 chunk: u, dt (B, L, di); B_in, C_in
    (B, L, ds); A (di, ds); h0 (B, di, ds). Returns (y (B, L, di), h_L)."""
    a = torch.exp(dt[..., None] * A)                            # (B,L,di,ds)
    b = dt[..., None] * B_in[:, :, None, :] * u[..., None]      # (B,L,di,ds)
    L = a.shape[1]
    step = 1
    while step < L:                    # Hillis-Steele: prefix over [0, t]
        a_prev, b_prev = a[:, :-step], b[:, :-step]
        a_cur, b_cur = a[:, step:], b[:, step:]
        b = torch.cat([b[:, :step], b_prev * a_cur + b_cur], dim=1)
        a = torch.cat([a[:, :step], a_prev * a_cur], dim=1)
        del a_prev, b_prev, a_cur, b_cur
        step *= 2
    h = a * h0[:, None] + b                                     # (B,L,di,ds)
    del a, b
    y = torch.einsum("blds,bls->bld", h, C_in)
    return y, h[:, -1]


def mamba_layer(p, x, cfg, *, state=None):
    """x (B, S, d); state (decode): dict(conv (B, dc - 1, di), h (B, di,
    ds)). Returns (out (B, S, d), new_state). `p` holds the parameters (a
    `Mamba`)."""
    B, S, _ = x.shape
    di, ds, dc = cfg.d_inner_mamba, cfg.mamba_d_state, cfg.mamba_d_conv
    dt_rank = p.dt_proj.shape[0]
    f32 = torch.float32

    xz = x @ p.in_proj
    u, z = xz.split(di, dim=-1)                                 # (B, S, di)

    # depthwise causal conv1d
    if state is not None:
        conv_in = torch.cat([state["conv"], u], dim=1)          # (B,dc-1+S,di)
    else:
        conv_in = Fn.pad(u, (0, 0, dc - 1, 0))
    new_conv = conv_in[:, -(dc - 1):]
    uc = conv_in[:, 0:S] * p.conv_w[0]
    for i in range(1, dc):
        uc = uc + conv_in[:, i:i + S] * p.conv_w[i]
    uc = Fn.silu(uc + p.conv_b)

    proj = uc @ p.x_proj                                        # (B,S,dtr+2ds)
    dt_low = proj[..., :dt_rank]
    B_in = proj[..., dt_rank:dt_rank + ds]
    C_in = proj[..., dt_rank + ds:]
    dt = Fn.softplus(dt_low @ p.dt_proj + p.dt_bias)            # (B, S, di)
    A = -torch.exp(p.A_log.to(f32))                             # (di, ds)

    h0 = state["h"] if state is not None else \
        torch.zeros((B, di, ds), dtype=f32, device=x.device)

    if S == 1:                                                  # decode step
        dA = torch.exp(dt[..., None] * A)[:, 0]
        dBu = (dt[..., None] * B_in[:, :, None, :] * uc[..., None])[:, 0]
        h = dA * h0 + dBu
        C = C_in[:, 0].to(torch.promote_types(h.dtype, C_in.dtype))
        y = torch.einsum("bds,bs->bd", h.to(C.dtype), C)[:, None]
        hT = h
    else:
        L = cfg.mamba_chunk
        if S % L or x.device.type == "meta":
            L = S
        ys = []
        hT = h0
        for c0 in range(0, S, L):
            sl = slice(c0, c0 + L)
            y_c, hT = _scan_chunk(uc[:, sl].to(f32), dt[:, sl].to(f32),
                                  B_in[:, sl].to(f32), C_in[:, sl].to(f32),
                                  A, hT)
            ys.append(y_c)
        y = torch.cat(ys, dim=1)

    y = (y + uc.to(f32) * p.D).to(x.dtype)
    out = (y * Fn.silu(z)) @ p.out_proj
    return out, {"conv": new_conv, "h": hT}


def init_mamba_state(cfg, batch: int, dtype=torch.float32, device=None):
    """Zero decode state: conv (B, dc - 1, di) in `dtype`, h (B, di, ds)
    float32."""
    return {"conv": torch.zeros((batch, cfg.mamba_d_conv - 1,
                                 cfg.d_inner_mamba), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, cfg.d_inner_mamba, cfg.mamba_d_state),
                             dtype=torch.float32, device=device)}
