"""Centralized aggregation of GP experts (paper §2.3.2): PoE, gPoE (eq.
12-13), BCM and rBCM (eq. 14-15) — the server-side references the
decentralized methods converge to. Counterpart of
`repro.core.prediction.aggregation` for the slice's four methods.

Each takes per-agent moments (M, Nt) and an optional agent mask (M,) or
(M, Nt); masked-out agents contribute nothing and M_eff = sum(mask).
"""
from __future__ import annotations

import torch


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
