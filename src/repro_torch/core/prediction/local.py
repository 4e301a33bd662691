"""Local GP sub-model moments (paper eq. 10-11), batched over agents.

Counterpart of `repro.core.prediction.local`, with the agent axis written
out where the reference vmapped.

  factor level — `chol_factors` computes each agent's Cholesky L_i and
  weights alpha_i = C_i^{-1} y_i once; the `*_cached` functions serve from
  them, so repeated query batches never refactorize.

  per-call wrapper — `local_moments` factorizes and predicts in one call;
  it is the reference path the cached engine is tested against.
"""
from __future__ import annotations

import torch

from ...kernels.ops import rbf_matvec_agents
from ..gp.kernel import cov_matrix, se_kernel, unpack


def chol_factors(log_theta, Xp, yp, jitter=1e-8):
    """Xp (M, Ni, D), yp (M, Ni) -> (L (M, Ni, Ni), alpha (M, Ni)) with
    L_i = chol(K(X_i, X_i) + sigma_eps^2 I) and alpha_i = C_i^{-1} y_i."""
    L = torch.linalg.cholesky(cov_matrix(Xp, log_theta, jitter))
    alpha = torch.cholesky_solve(yp[..., None], L)[..., 0]
    return L, alpha


def stream_means(log_theta, Xp, alpha, Xs):
    """Per-agent posterior means mu_i = k(Xs, X_i) alpha_i (the eq. 10 mean
    term) through the fused Gram-matvec kernel, O(Ni + Nt) memory per
    agent. Returns (M, Nt) in Xs's dtype."""
    ls, sigma_f, _ = unpack(log_theta)
    return rbf_matvec_agents(Xs, Xp, alpha, ls, sigma_f**2).to(Xs.dtype)


def local_moments_cached(log_theta, Xp, L, alpha, Xs,
                         stream_mean: bool = False):
    """Local moments (eq. 10-11) from precomputed factors -> mu, var, each
    (M, Nt).

    `stream_mean=True` takes the mean through the fused kernel (the serving
    hot path, which shares the variance's unpacked theta and sigma_f^2);
    the variance needs the triangular solve against the cached factor
    either way.
    """
    ls, sigma_f, _ = unpack(log_theta)
    sf2 = sigma_f**2
    ks = se_kernel(Xp, Xs[None], log_theta)                  # (M, Ni, Nt)
    v = torch.linalg.solve_triangular(L, ks, upper=False)
    var = torch.clamp(sf2 - (v * v).sum(dim=-2), min=1e-12)
    if stream_mean:
        return rbf_matvec_agents(Xs, Xp, alpha, ls, sf2).to(Xs.dtype), var
    return torch.einsum("mnt,mn->mt", ks, alpha), var


def local_moments(log_theta, Xp, yp, Xs, jitter=1e-8):
    """Per-call wrapper (factorize, then predict) for eq. 10-11."""
    L, alpha = chol_factors(log_theta, Xp, yp, jitter)
    return local_moments_cached(log_theta, Xp, L, alpha, Xs)
