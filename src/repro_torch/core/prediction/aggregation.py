"""Centralized aggregation of GP experts (paper §2.3.2): PoE, gPoE (eq.
12-13), BCM, rBCM (eq. 14-15), grBCM (eq. 16-17) and NPAE (eq. 20-21) —
the server-side references the decentralized methods converge to (zero
approximation error for the DAC-based ones). Counterpart of
`repro.core.prediction.aggregation`.

Each takes per-agent moments (M, Nt) and an optional agent mask (M,) or
(M, Nt); masked-out agents contribute nothing and M_eff = sum(mask).
"""
from __future__ import annotations

import torch

from ..gp.nll import cholesky


def _mask_of(mu, mask):
    if mask is None:
        return torch.ones_like(mu)
    m = mask if mask.dim() == mu.dim() else mask[:, None]
    return torch.broadcast_to(m, mu.shape).to(mu.dtype)


def poe(mu, var, mask=None):
    """PoE (eq. 12-13), beta_i = 1."""
    m = _mask_of(mu, mask)
    prec = (m / var).sum(0)
    return (m * mu / var).sum(0) / prec, 1.0 / prec


def gpoe(mu, var, mask=None):
    """gPoE (eq. 12-13), beta_i = 1/M (Deisenroth & Ng)."""
    m = _mask_of(mu, mask)
    beta = m / m.sum(0)
    prec = (beta / var).sum(0)
    return (beta * mu / var).sum(0) / prec, 1.0 / prec


def bcm(mu, var, prior_var, mask=None):
    """BCM (eq. 14-15), beta_i = 1."""
    m = _mask_of(mu, mask)
    prec = (m / var).sum(0) + (1.0 - m.sum(0)) / prior_var
    return (m * mu / var).sum(0) / prec, 1.0 / prec


def rbcm(mu, var, prior_var, mask=None):
    """rBCM (eq. 14-15), beta_i = 0.5(log prior_var - log var_i)."""
    m = _mask_of(mu, mask)
    beta = 0.5 * (torch.log(prior_var) - torch.log(var)) * m
    prec = (beta / var).sum(0) + (1.0 - beta.sum(0)) / prior_var
    return (beta * mu / var).sum(0) / prec, 1.0 / prec


def grbcm(mu_aug, var_aug, mu_c, var_c, mask=None):
    """grBCM (eq. 16-17): experts use augmented moments; the communication
    expert (mu_c, var_c) anchors consistency. beta_1 = 1,
    beta_i = 0.5(log var_c - log var_{+i}) for i >= 2."""
    m = _mask_of(mu_aug, mask)
    beta = 0.5 * (torch.log(var_c)[None] - torch.log(var_aug))
    beta[0] = 1.0
    beta = beta * m
    sum_beta = beta.sum(0)
    prec = (beta / var_aug).sum(0) + (1.0 - sum_beta) / var_c
    mean = ((beta * mu_aug / var_aug).sum(0)
            - (sum_beta - 1.0) * mu_c / var_c) / prec
    return mean, 1.0 / prec


def npae(mu, kA, CA, prior_var, mask=None, jitter=1e-8):
    """NPAE (eq. 20-21): mu = k_A^T C_A^-1 mu ; var = k** - k_A^T C_A^-1 k_A.

    mu, kA (M, Nt); CA (Nt, M, M). A mask restricts aggregation to selected
    agents by zeroing their rows/cols and placing 1 on excluded diagonals.

    `jitter` is relative to the mean diagonal of each C_A and floored at
    8*eps(dtype), since a relative nudge below the dtype's ulp would round
    away entirely (1e-8 is a no-op on float32 diagonals).
    """
    M = mu.shape[0]
    eye = torch.eye(M, dtype=mu.dtype, device=mu.device)
    if mask is not None:
        mkT = _mask_of(mu, mask).T                           # (Nt, M)
        # zero cross terms with excluded agents; unit diagonal decouples them
        CA = CA * (mkT[:, :, None] * mkT[:, None, :]) \
            + eye[None] * (1.0 - mkT)[:, None, :]
        kA = kA * mkT.T
        mu = mu * mkT.T
    rel = max(jitter, 8 * torch.finfo(CA.dtype).eps)
    scale = torch.diagonal(CA, dim1=-2, dim2=-1).mean(-1)      # (Nt,)
    C = CA + (1e-12 + rel * scale)[:, None, None] * eye
    L = cholesky(C)
    rhs = torch.stack([mu.T, kA.T], -1)                        # (Nt, M, 2)
    q = torch.linalg.solve_triangular(
        L.mT, torch.linalg.solve_triangular(L, rhs, upper=False),
        upper=True)
    k = kA.T[..., None]
    mean, kck = (k * q).sum(-2).unbind(-1)                     # (Nt,), (Nt,)
    return mean, torch.clamp(prior_var - kck, min=1e-12)
