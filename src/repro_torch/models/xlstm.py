"""xLSTM blocks (Beck et al. 2024, arXiv:2405.04517): the counterpart of
repro.models.xlstm.

    out, state = mlstm_layer(cell, x, cfg, state=None)   # x (B, S, d)
    out, state = slstm_layer(cell, x, cfg, state=None)

mLSTM keeps a matrix memory C (B, H, hd, hd), a normalizer n (B, H, hd)
and a running log-space maximum m (B, H). A prefill runs the
chunkwise-parallel form `_mlstm_chunk` over chunks of `cfg.xlstm_chunk`
tokens, carrying (C, n, m) from chunk to chunk; a length the chunk does
not divide runs as one chunk of the whole sequence (the reference's rule,
`L = xlstm_chunk if S % xlstm_chunk == 0 else S`, so a ragged prompt
builds (B, H, S, S) scores, as `models/mamba.py` keeps its own chunk
rule). A decode step (S = 1) runs `mlstm_sequential`, the step-by-step
recurrence that is also the tests' oracle. Within a chunk the masked
decay is filled with -inf before its exp, so the masked entries have
weight 0 and a zero gradient however large the unmasked decay would be.

sLSTM keeps (h, c, n, m) (B, H, hd) and mixes its memory through the
per-head recurrent matrices rz, ri, rf; it is a true RNN, a Python loop
over time (the reference's `lax.scan`; neither gives it a parallel form).
On meta tensors (launch/dryrun.py's shape-only step) the loop is traced
at once, with the loop's products and FLOPs (`_slstm_traced`).

Every recurrence runs in float32 whatever the model's dtype: q, k, v, the
log gates and the sLSTM pre-activations are cast to float32, and the
outputs cast back to the input's dtype before the output projection, as
the reference casts them. The states start with m = -1e30 in float32,
not -inf: the rule max(|q . n|, exp(-m)) relies on exp(-1e30 + ...)
underflowing to 0, and -inf would give -inf - (-inf) = NaN in the
stabilizer's differences.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as Fn

from .common import init_scale, rmsnorm

#: the initial log-space maximum of every state (float32)
M_INIT = -1e30


def _params(module, shapes: dict, dtype, device) -> None:
    for name, shape in shapes.items():
        setattr(module, name, nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device)))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """wq, wk, wv, wo_gate (d, H, hd), wi and wf (d, H), wo (H, hd, d) and
    ln_out (H, hd) of one mLSTM cell, in the reference's shapes
    (`mlstm_defs`)."""

    AXES = {"wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "heads", "head_dim"),
            "wv": ("embed", "heads", "head_dim"),
            "wi": ("embed", "heads"),
            "wf": ("embed", "heads"),
            "wo_gate": ("embed", "heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed_out"),
            "ln_out": ("heads", "head_dim")}

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        d, H, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
        _params(self, {"wq": (d, H, hd), "wk": (d, H, hd), "wv": (d, H, hd),
                       "wi": (d, H), "wf": (d, H), "wo_gate": (d, H, hd),
                       "wo": (H, hd, d), "ln_out": (H, hd)}, dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The reference's initializers: 0.02 for wi and wf
        (`small_normal`), ones for ln_out, 1 / sqrt(fan_in) (the first
        axis: d, or H for wo) for the rest."""
        self.ln_out.fill_(1.0)
        for w in (self.wi, self.wf):
            w.normal_(0.0, init_scale("small_normal", 0), generator=generator)
        for w in (self.wq, self.wk, self.wv, self.wo_gate, self.wo):
            w.normal_(0.0, init_scale("normal", w.shape[0]),
                      generator=generator)

    def forward(self, x, state=None):
        return mlstm_layer(self, x, self.cfg, state=state)


def _mlstm_chunk(q, k, v, lf, li, state):
    """One chunk, all heads: q, k, v (B, H, L, hd) float32, lf and li
    (B, H, L) the log forget and input gates, state {C (B, H, hd, hd),
    n (B, H, hd), m (B, H)}. Returns (h (B, H, L, hd), new_state)."""
    B, H, L, hd = q.shape
    b = torch.cumsum(lf, dim=-1)                       # cumulative log f
    g = li - b
    gmax = torch.cummax(g, dim=-1).values              # max_{tau<=t} g_tau
    m_intra = b + gmax
    m_inter = state["m"][..., None] + b
    m_t = torch.maximum(m_inter, m_intra)              # (B, H, L)

    scale = 1.0 / (hd ** 0.5)
    scores = torch.einsum("bhld,bhtd->bhlt", q, k) * scale  # l query, t key
    future = torch.ones((L, L), dtype=torch.bool, device=q.device) \
        .triu(diagonal=1)
    decay = b[..., :, None] - b[..., None, :] + li[..., None, :] \
        - m_t[..., :, None]
    w = torch.exp(decay.masked_fill(future, float("-inf")))
    sw = scores * w
    num_intra = torch.einsum("bhlt,bhtd->bhld", sw, v)
    den_intra = sw.sum(dim=-1)

    coef = torch.exp(m_inter - m_t)
    num_inter = torch.einsum("bhld,bhde->bhle", q, state["C"]) \
        * coef[..., None]
    den_inter = torch.einsum("bhld,bhd->bhl", q, state["n"]) * coef

    num = num_intra + num_inter
    den = den_intra + den_inter
    # the unstabilized rule max(|q . n|, 1) in exp(-m)-stabilized units
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]

    # the state at the chunk's end
    bL = b[..., -1]                                    # (B, H)
    m_new = torch.maximum(state["m"] + bL, bL + gmax[..., -1])
    upd_w = torch.exp(li + bL[..., None] - b - m_new[..., None])
    keep = torch.exp(state["m"] + bL - m_new)
    ks = k * scale
    C_new = keep[..., None, None] * state["C"] \
        + torch.einsum("bhl,bhld,bhle->bhde", upd_w, ks, v)
    n_new = keep[..., None] * state["n"] \
        + torch.einsum("bhl,bhld->bhd", upd_w, ks)
    return h, {"C": C_new, "n": n_new, "m": m_new}


def mlstm_sequential(q, k, v, lf, li, state):
    """The same stabilized recurrence one step at a time (the decode path
    and the tests' oracle); arguments and returns as `_mlstm_chunk`'s."""
    scale = 1.0 / q.shape[-1] ** 0.5
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for t in range(q.shape[2]):
        qt, kt, vt = q[:, :, t], k[:, :, t], v[:, :, t]
        lft, lit = lf[..., t], li[..., t]
        m_new = torch.maximum(m + lft, lit)
        fw = torch.exp(m + lft - m_new)
        iw = torch.exp(lit - m_new)
        ks = kt * scale
        C = fw[..., None, None] * C \
            + iw[..., None, None] * ks[..., :, None] * vt[..., None, :]
        n = fw[..., None] * n + iw[..., None] * ks
        num = torch.einsum("bhd,bhde->bhe", qt, C)
        den = torch.einsum("bhd,bhd->bh", qt, n)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None])
        m = m_new
    return torch.stack(hs, dim=2), {"C": C, "n": n, "m": m}


def mlstm_layer(p, x, cfg, *, state=None):
    """x (B, S, d) -> (out (B, S, d), new_state); `p` holds the parameters
    (an `MLSTM`), `state` the {C, n, m} of a decode cache (None: zeros
    and m = -1e30). Chunks of `cfg.xlstm_chunk` tokens when that divides
    S, else one chunk of S; S = 1 steps the recurrence once."""
    B, S, _ = x.shape
    f32 = torch.float32
    q = torch.einsum("bsd,dhk->bhsk", x, p.wq)
    k = torch.einsum("bsd,dhk->bhsk", x, p.wk)
    v = torch.einsum("bsd,dhk->bhsk", x, p.wv)
    lf = Fn.logsigmoid(torch.einsum("bsd,dh->bhs", x, p.wf).to(f32))
    li = torch.einsum("bsd,dh->bhs", x, p.wi).to(f32)
    if state is None:
        state = init_mlstm_state(cfg, B, x.device)
    qf, kf, vf = (t.to(f32) for t in (q, k, v))

    if S == 1:
        h, new_state = mlstm_sequential(qf, kf, vf, lf, li, state)
    else:
        L = cfg.xlstm_chunk if S % cfg.xlstm_chunk == 0 else S
        hs, new_state = [], state
        for c0 in range(0, S, L):
            sl = slice(c0, c0 + L)
            h_c, new_state = _mlstm_chunk(qf[:, :, sl], kf[:, :, sl],
                                          vf[:, :, sl], lf[..., sl],
                                          li[..., sl], new_state)
            hs.append(h_c)
        h = torch.cat(hs, dim=2) if len(hs) > 1 else hs[0]

    # per-head output norm, then the sigmoid output gate
    h = rmsnorm(h, p.ln_out[None, :, None, :], eps=cfg.norm_eps)
    h = h * torch.sigmoid(torch.einsum("bsd,dhk->bhsk", x, p.wo_gate))
    out = torch.einsum("bhsk,hkd->bsd", h.to(x.dtype), p.wo)
    return out, new_state


def init_mlstm_state(cfg, batch: int, device=None):
    """Zero mLSTM state, float32: C (B, H, hd, hd), n (B, H, hd), and
    m (B, H) at -1e30."""
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, hd, hd), **f32),
            "n": torch.zeros((batch, H, hd), **f32),
            "m": torch.full((batch, H), M_INIT, **f32)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """wz, wi, wf, wo_g (d, H, hd), the recurrent rz, ri, rf (H, hd, hd)
    and wo (H, hd, d) of one sLSTM cell (`slstm_defs`)."""

    AXES = {"wz": ("embed", "heads", "head_dim"),
            "wi": ("embed", "heads", "head_dim"),
            "wf": ("embed", "heads", "head_dim"),
            "wo_g": ("embed", "heads", "head_dim"),
            "rz": ("heads", "head_dim", "head_dim_r"),
            "ri": ("heads", "head_dim", "head_dim_r"),
            "rf": ("heads", "head_dim", "head_dim_r"),
            "wo": ("heads", "head_dim", "embed_out")}

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        d, H, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
        _params(self, {"wz": (d, H, hd), "wi": (d, H, hd), "wf": (d, H, hd),
                       "wo_g": (d, H, hd), "rz": (H, hd, hd),
                       "ri": (H, hd, hd), "rf": (H, hd, hd),
                       "wo": (H, hd, d)}, dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The reference's initializers: 0.02 for wi, wf and the recurrent
        matrices (`small_normal`), 1 / sqrt(fan_in) (d, or H for wo) for
        wz, wo_g and wo."""
        for w in (self.wi, self.wf, self.rz, self.ri, self.rf):
            w.normal_(0.0, init_scale("small_normal", 0), generator=generator)
        for w in (self.wz, self.wo_g, self.wo):
            w.normal_(0.0, init_scale("normal", w.shape[0]),
                      generator=generator)

    def forward(self, x, state=None):
        return slstm_layer(self, x, self.cfg, state=state)


def slstm_layer(p, x, cfg, *, state=None):
    """sLSTM with exponential gating and per-head recurrent memory mixing:
    x (B, S, d) -> (out (B, S, d), new_state), `state` {h, c, n, m} each
    (B, H, hd) (None: zeros and m = -1e30). The recurrent products of one
    step run as one einsum against [rz | ri | rf]. On meta tensors (the
    dry run, which computes nothing) the S steps are traced at once
    (`_slstm_traced`)."""
    B, S, _ = x.shape
    if state is None:
        state = init_slstm_state(cfg, B, x.device)
    f32 = torch.float32
    zx, ix, fx, ox = (torch.einsum("bsd,dhk->sbhk", x, w).to(f32)
                      for w in (p.wz, p.wi, p.wf, p.wo_g))
    r = torch.cat([p.rz, p.ri, p.rf], dim=-1)
    r = r.to(torch.promote_types(state["h"].dtype, r.dtype))
    run = _slstm_traced if x.device.type == "meta" else _slstm_steps
    hs, new_state = run(zx, ix, fx, torch.sigmoid(ox), r, state,
                        cfg.resolved_head_dim)
    out = torch.einsum("bshk,hkd->bsd", hs.transpose(0, 1).to(x.dtype), p.wo)
    return out, new_state


def _slstm_step(zt, it, ft, ogt, rec, c, n, m, hd):
    """One step's gates and state update from its recurrent products rec
    = h_{t-1} [rz | ri | rf]: returns (h, c, n, m)."""
    rz, ri, rf = rec.split(hd, dim=-1)
    z = torch.tanh(zt + rz)
    i_til = it + ri
    lf_m = Fn.logsigmoid(ft + rf) + m
    m_new = torch.maximum(lf_m, i_til)
    i_p = torch.exp(i_til - m_new)
    f_p = torch.exp(lf_m - m_new)
    c = f_p * c + i_p * z
    n = f_p * n + i_p
    return ogt * c / torch.clamp(n, min=1.0), c, n, m_new


def _slstm_steps(zx, ix, fx, og, r, state, hd):
    """The recurrence, one step at a time over the time axis of the
    (S, B, H, hd) pre-activations: (hs (S, B, H, hd), final state)."""
    h, c, n, m = state["h"], state["c"], state["n"], state["m"]
    hs = []
    for t in range(zx.shape[0]):
        h, c, n, m = _slstm_step(zx[t], ix[t], fx[t], og[t],
                                 torch.einsum("bhk,hkl->bhl", h, r),
                                 c, n, m, hd)
        hs.append(h)
    return torch.stack(hs), {"h": h, "c": c, "n": n, "m": m}


def _slstm_traced(zx, ix, fx, og, r, state, hd):
    """`_slstm_steps` for meta tensors: the same products, shapes, dtypes
    and autograd graph with S times fewer dispatches. A loop on meta runs
    a Python meta kernel per operation and step (tools/meta_op_cost.py),
    about 20 a step, 2 M for three layers at 32,768 tokens; here step
    0's recurrent product runs on the state's h and the other S - 1
    steps' as one einsum over a stand-in of their hidden states
    (requiring grad where the loop's would), then one step's elementwise
    body over the whole (S, B, H, hd) stack. The
    products' FLOPs, counted by FlopCounterMode, are the loop's, forward
    and backward."""
    S = zx.shape[0]
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (zx, ix, fx, og, r, *state.values()))
    later = torch.empty_like(og[1:]).requires_grad_(grad)
    rec = torch.cat([torch.einsum("bhk,hkl->bhl", state["h"], r)[None],
                     torch.einsum("sbhk,hkl->sbhl", later, r)])
    c, n, m = (state[k].expand((S,) + state[k].shape) for k in "cnm")
    hs, c, n, m = _slstm_step(zx, ix, fx, og, rec, c, n, m, hd)
    return hs, {"h": hs[-1], "c": c[-1], "n": n[-1], "m": m[-1]}


def init_slstm_state(cfg, batch: int, device=None):
    """Zero sLSTM state, float32: h, c, n (B, H, hd) and m (B, H, hd) at
    -1e30."""
    shape = (batch, cfg.num_heads, cfg.resolved_head_dim)
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros(shape, **f32), "c": torch.zeros(shape, **f32),
            "n": torch.zeros(shape, **f32),
            "m": torch.full(shape, M_INIT, **f32)}
