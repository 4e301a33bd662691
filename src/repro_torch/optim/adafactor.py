"""Adafactor (Shazeer & Stern 2018) with factored second moments
(counterpart of `repro.optim.adafactor`).

A leaf whose last two dimensions are both >= `min_dim_factored` keeps its
second moment as a row statistic vr (..., rows) and a column statistic vc
(..., cols) instead of a full matrix; other leaves keep v. The decay is
beta2 = 1 - step^-decay, each update is clipped to RMS `clip_threshold`,
and there is no first moment. Params are a tensor or a dict of tensors,
as for `adam`; the statistics are float32.
"""
from __future__ import annotations

import torch

from .adam import Optimizer, _lr_at, _leaves, _tree_map


def adafactor(lr, eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8, min_dim_factored: int = 128) -> Optimizer:
    def factored(p):
        return p.dim() >= 2 and p.shape[-1] >= min_dim_factored and \
            p.shape[-2] >= min_dim_factored

    def init(params):
        def stat(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        dev = _leaves(params)[0].device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "stats": _tree_map(stat, params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        beta2 = 1.0 - step.to(torch.float32) ** (-decay)
        lr_t = _lr_at(lr, step)

        def upd(g, s):
            g = g.to(torch.float32)
            g2 = g.square() + eps
            if "vr" in s:
                vr = beta2 * s["vr"] + (1 - beta2) * g2.mean(-1)
                vc = beta2 * s["vc"] + (1 - beta2) * g2.mean(-2)
                denom = (vr / vr.mean(-1, keepdim=True))[..., None] \
                    * vc[..., None, :]
                u = g / torch.sqrt(denom + eps)
                ns = {"vr": vr, "vc": vc}
            else:
                v = beta2 * s["v"] + (1 - beta2) * g2
                u = g / torch.sqrt(v + eps)
                ns = {"v": v}
            rms = torch.sqrt(u.square().mean() + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return -lr_t * u, ns

        outs = _tree_map(upd, grads, state["stats"])
        if isinstance(outs, dict):
            updates = {k: o[0] for k, o in outs.items()}
            stats = {k: o[1] for k, o in outs.items()}
        else:
            updates, stats = outs
        return updates, {"step": step, "stats": stats}

    return Optimizer(init, update)
