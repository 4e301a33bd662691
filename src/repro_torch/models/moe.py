"""Mixture-of-Experts FFN with GShard-style capacity dispatch (top-k,
groups): the counterpart of repro.models.moe.

    out, aux = moe_ffn(moe, x, cfg)       # x (B, S, d)

Tokens are cut into G groups of g (g the largest divisor of B S up to
`cfg.moe_group_size`); in each group an expert takes at most C tokens,
C = max(1, round(k g capacity_factor / E)) with Python's `round`, and
C = g k at S = 1 (decode: drop-free). Slots go to the choices in
choice-major order (every token's first choice before any second choice)
and a choice past its expert's capacity is dropped. The router's logits
are cast to float32 whatever the model's dtype, as the reference casts
them, so the softmax and the top-k pick the same experts in a float64 run
as in a float32 one. The expert products are dense einsums over the
one-hot dispatch and combine tensors (G, g, E, C), as in the reference,
and the grouped tokens, the dispatch and combine tensors, the experts'
inputs, hidden activations and the output are pinned where the
reference pins them (`act_sharding.constrain`: experts on the model
axis, groups on the batch axes; a no-op without a mesh).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as Fn

from .act_sharding import constrain
from .common import init_scale


class MoE(nn.Module):
    """router (d, E), wg and wu (E, d, f), wd (E, f, d) of one MoE FFN."""

    AXES = {"router": ("embed", "experts_logits"),
            "wg": ("experts", "embed", "ffn"),
            "wu": ("experts", "embed", "ffn"),
            "wd": ("experts", "ffn", "embed_out")}

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        shapes = {"router": (d, E), "wg": (E, d, f), "wu": (E, d, f),
                  "wd": (E, f, d)}
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device)))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The reference's scales: 0.02 for the router (`small_normal`),
        1 / sqrt(fan_in) for the experts, fan_in their axis 1 (d for wg
        and wu, f for wd: `scale_axis=1`)."""
        self.router.normal_(0.0, init_scale("small_normal", 0),
                            generator=generator)
        for w in (self.wg, self.wu, self.wd):
            w.normal_(0.0, init_scale("normal", w.shape[1]),
                      generator=generator)

    def forward(self, x):
        return moe_ffn(self, x, self.cfg)


def capacity(cfg, B: int, S: int) -> tuple[int, int]:
    """(g, C): the group size and each expert's capacity per group for a
    (B, S) batch, as the reference's moe_ffn computes them."""
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    g = min(cfg.moe_group_size, T)
    while T % g:                       # largest divisor of T <= group_size
        g -= 1
    cap = int(max(1, round(k * g * cfg.moe_capacity_factor / E)))
    if S == 1:
        cap = g * k                    # decode: drop-free
    return g, cap


def route(p, xt, cfg, cap: int):
    """The dispatch of grouped tokens xt (G, g, d): (disp, comb, aux) with
    disp and comb (G, g, E, C) in xt's dtype (comb carries the normalized
    top-k weights) and the Switch load-balance loss, float32."""
    G, g, _ = xt.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    f32 = torch.float32
    logits = torch.einsum("Ggd,de->Gge", xt, p.router).to(f32)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)                 # (G, g, k)
    top_w = top_w / top_w.sum(-1, keepdim=True)

    # load-balance auxiliary loss (Switch): E * sum_e f_e * p_e
    onehot = Fn.one_hot(top_e, E).to(f32)                       # (G, g, k, E)
    me = probs.mean(dim=(0, 1))
    ce = onehot.sum(2).mean(dim=(0, 1))
    aux = E * (me * ce).sum() / k

    # choice-major priority positions within each expert
    oh_cm = onehot.permute(0, 2, 1, 3).reshape(G, k * g, E)
    pos = torch.cumsum(oh_cm, dim=1) - oh_cm                    # (G, kg, E)
    keep = (pos < cap) * oh_cm
    pos = pos.reshape(G, k, g, E)
    keep = keep.reshape(G, k, g, E)

    # one (G, g, E, C) one-hot a choice; a position past the capacity has
    # keep 0 (the reference's one_hot gives it no slot at all)
    cdt = xt.dtype
    disp = torch.zeros((G, g, E, cap), dtype=cdt, device=xt.device)
    comb = torch.zeros_like(disp)
    for j in range(k):
        slot_j = Fn.one_hot(pos[:, j].long().clamp(max=cap - 1), cap) \
            .to(cdt) * keep[:, j][..., None].to(cdt)
        disp = disp + slot_j
        comb = comb + slot_j * top_w[:, :, j][..., None, None].to(cdt)
    return disp, comb, aux


def moe_ffn(p, x, cfg):
    """x (B, S, d) -> (out (B, S, d), aux_loss 0-d float32); `p` holds
    router, wg, wu, wd (an `MoE`)."""
    B, S, d = x.shape
    g, cap = capacity(cfg, B, S)
    xt = constrain(x.reshape(B * S // g, g, d), ("batch", None, None))
    disp, comb, aux = route(p, xt, cfg, cap)
    disp = constrain(disp, ("batch", None, "experts", None))
    comb = constrain(comb, ("batch", None, "experts", None))
    expert_in = torch.einsum("GgEC,Ggd->GECd", disp, xt)
    expert_in = constrain(expert_in, ("batch", "experts", None, None))
    h = Fn.silu(torch.einsum("GECd,Edf->GECf", expert_in, p.wg)) \
        * torch.einsum("GECd,Edf->GECf", expert_in, p.wu)
    del expert_in
    h = constrain(h, ("batch", "experts", None, "ffn"))
    expert_out = torch.einsum("GECf,Efd->GECd", h, p.wd)
    del h
    out = torch.einsum("GgEC,GECd->Ggd", comb, expert_out)
    out = constrain(out, ("batch", None, None))
    return out.reshape(B, S, d), aux
