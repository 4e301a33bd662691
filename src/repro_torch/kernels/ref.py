"""Plain PyTorch oracles for the kernels (counterpart of repro.kernels.ref).

They materialize what the kernels stream and are ground truth for
allclose tests.
"""
from __future__ import annotations

import torch


def rbf_gram_ref(x1, x2, lengthscales, sigma_f, noise: float = 0.0):
    """sigma_f^2 exp(-sum_d (x1_d - x2_d)^2 / l_d^2) (+ noise^2 I).

    x1 (N, D), x2 (M, D) -> (N, M). Matches core.gp.kernel.se_kernel.
    """
    a = x1 / lengthscales
    b = x2 / lengthscales
    d2 = ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
          - 2.0 * a @ b.T)
    K = sigma_f**2 * torch.exp(-torch.clamp(d2, min=0.0))
    if noise:
        K = K + noise**2 * torch.eye(x1.shape[0], x2.shape[0],
                                     dtype=K.dtype, device=K.device)
    return K


def kmn_stats_ref(Z, X, y, lengthscales, sigma_f):
    """Titsias statistics (B = Kmn Knm, b = Kmn y) through the materialized
    Kmn = k(Z, X) (m, N)."""
    Kmn = rbf_gram_ref(Z, X, lengthscales, sigma_f)
    return Kmn @ Kmn.T, Kmn @ y


def flash_attention_ref(q, k, v, causal: bool = True, scale=None,
                        window=None):
    """Reference attention. q (B,H,Sq,D), k/v (B,KH,Sk,D) with H % KH == 0.

    `window` enables sliding-window attention (keys within `window`
    positions behind the query). Query positions are right-aligned to the
    key timeline (decode: Sq=1 attends to the full cache). Materializes the
    repeated k/v and the logits, computes in float32 and returns q's dtype,
    which is what the reference's Pallas kernel and chunked jnp path return.
    """
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    g = H // KH
    if scale is None:
        scale = 1.0 / D ** 0.5
    k = torch.repeat_interleave(k.to(torch.float32), g, dim=1)
    v = torch.repeat_interleave(v.to(torch.float32), g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k) * scale
    q_pos = torch.arange(Sq, device=q.device) + (Sk - Sq)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    logits = logits.masked_fill(~mask, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v).to(q.dtype)


def rbf_matvec_ref(x1, x2, v, lengthscales, sigma_f):
    """k(X1, X2) @ v through the materialized Gram."""
    return rbf_gram_ref(x1, x2, lengthscales, sigma_f) @ v


def nll_grad_fused_ref(log_theta, d2u, inner, K=None, bn: int = 256):
    """Fused trace-identity NLL gradient, the blocked mirror of the kernel.

    d2u (..., D, N, N) is the once-per-fit unscaled diff^2 stack, inner
    (..., N, N) is C^-1 - alpha alpha^T, log_theta (D+2,) or (..., D+2).
    Returns dNLL/dlog_theta (..., D+2) without the (D+2, N, N) derivative
    stack: row blocks of `bn` rows are taken in turn (O(D bn N)
    transients), each contributing all D+2 components. `K` optionally
    reuses an already-built kernel matrix; without it K is rebuilt per
    block from d2u, as the kernel does in registers.

      d/dlog l_d  = sum W * d2u[d] / l_d^2      with W = inner * K
      d/dlog sf   = sum W
      d/dlog se   = sigma_eps^2 tr(inner)
    """
    D, n = d2u.shape[-3], d2u.shape[-1]
    theta = torch.exp(log_theta)
    ls, sigma_f, sigma_eps = theta[..., :D], theta[..., D], theta[..., D + 1]
    inv_l2 = 1.0 / ls**2
    sums = 0.0
    for r0 in range(0, n, bn):
        d2u_b = d2u[..., r0:r0 + bn, :]
        if K is None:
            K_b = sigma_f[..., None, None]**2 * torch.exp(
                -torch.einsum("...d,...dij->...ij", inv_l2, d2u_b))
        else:
            K_b = K[..., r0:r0 + bn, :]
        W = inner[..., r0:r0 + bn, :] * K_b
        sums = sums + torch.cat([torch.einsum("...dij,...ij->...d", d2u_b, W),
                                 W.sum((-2, -1))[..., None]], -1)
    tr = torch.diagonal(inner, dim1=-2, dim2=-1).sum(-1)
    return torch.cat([sums[..., :D] * inv_l2, sums[..., D:D + 1],
                      (sigma_eps**2 * tr)[..., None]], -1)


def cholupdate_ref(L, x, downdate: bool = False, bk: int = 128,
                   shift: int = 0):
    """Rank-1 Cholesky update/downdate chol(L L^T + sign x x^T) in O(n^2),
    the blocked mirror of the reference's `ref.cholupdate_ref`.

    One factor L (n, n), x (n,). Columns go in `bk`-wide panels; a panel
    whose x entries are all zero is skipped (padding and the zero head of
    an eviction vector are untouched). Within a panel each step takes the
    whole trailing column without masking the rows above the diagonal and
    keeps it unscaled until the panel ends; the garbage above the diagonal
    is zeroed with one triu per panel. `shift=k` updates the trailing block
    L[k:, k:] with x[k:] and writes it k slots up-left; rows and columns
    n-k .. n-1 keep L's (stale) values. The sqrt argument is clamped to the
    dtype's tiny, so a marginally indefinite downdate degrades instead of
    giving NaN.
    """
    n = L.shape[0]
    sign = -1.0 if downdate else 1.0
    tiny = torch.finfo(L.dtype).tiny
    L, x = L.clone(), x.clone()
    for k0 in range(shift, n, bk):
        b = min(bk, n - k0)
        panel = L[k0:, k0:k0 + b].clone()                  # (m, b)
        xc = x[k0:].clone()
        if bool((xc[:b] != 0).any()):
            cols, cs = [], []
            for t in range(b):
                col = panel[:, t]
                Lkk, xk = col[t], xc[t]
                r = torch.sqrt(torch.clamp(Lkk * Lkk + sign * xk * xk,
                                           min=tiny))
                c = r / Lkk
                s = xk / Lkk
                u = col + (sign * s) * xc
                u[t] = r * c                               # newcol * c
                xc = c * xc - (s / c) * u
                cols.append(u)
                cs.append(c)
            cols = torch.stack(cols) / torch.stack(cs)[:, None]
            cols[:, :b] = torch.triu(cols[:, :b])
            panel = cols.T
        L[k0 - shift:n - shift, k0 - shift:k0 + b - shift] = panel
        x[k0:] = xc
    return L
