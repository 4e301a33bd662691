"""Local GP sub-model moments (paper eq. 10-11) and NPAE local quantities
(eq. 18-19), batched over agents.

Counterpart of `repro.core.prediction.local`, with the agent axis written
out where the reference vmapped.

  factor level — `chol_factors` computes each agent's Cholesky L_i and
  weights alpha_i = C_i^{-1} y_i once; the `*_cached` functions serve from
  them, so repeated query batches never refactorize.

  per-call wrappers — `local_moments` / `npae_terms` factorize and predict
  in one call; they are the reference path the cached engine is tested
  against.

Every C^{-1} b is two triangular solves against the factor
(`core.gp.nll.cho_solve`), not `torch.cholesky_solve` (ROADMAP C5).
"""
from __future__ import annotations

import torch

from ...kernels.ops import rbf_matvec_agents
from ..gp.kernel import cov_matrix, se_kernel, unpack
from ..gp.nll import cho_solve


def chol(Xp, log_theta, jitter=1e-8):
    """L_i = chol(K(X_i, X_i) + (sigma_eps^2 + jitter) I), batched."""
    return torch.linalg.cholesky(cov_matrix(Xp, log_theta, jitter))


def chol_factors(log_theta, Xp, yp, jitter=1e-8):
    """Xp (M, Ni, D), yp (M, Ni) -> (L (M, Ni, Ni), alpha (M, Ni)) with
    L_i = chol(K(X_i, X_i) + sigma_eps^2 I) and alpha_i = C_i^{-1} y_i."""
    L = chol(Xp, log_theta, jitter)
    return L, cho_solve(L, yp)


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


def cross_gram(log_theta, Xp):
    """All cross-agent Gram blocks K(X_i, X_j) -> (M, M, Ni, Ni), built one
    row of blocks at a time (transients of one row).

    O(M^2 Ni^2) memory: `fit_experts(cache_cross=True)` guards the
    estimate before materializing; `npae_terms_cached` consumes it to skip
    the per-query-batch cross-covariance assembly."""
    M, Ni = Xp.shape[:2]
    out = Xp.new_empty((M, M, Ni, Ni))
    for i in range(M):
        out[i] = se_kernel(Xp[i], Xp, log_theta)
    return out


def npae_terms_cached(log_theta, Xp, L, alpha, Xs, Kcross=None):
    """NPAE aggregation terms (paper eq. 18-21 context) from cached factors.

    Returns (mu (M, Nt), k_A (M, Nt), C_A (Nt, M, M)) where
      [k_A]_i  = k_{i,*}^T C_i^-1 k_{i,*}                         (eq. 18)
      [C_A]_ij = k_{i,*}^T C_i^-1 K(X_i, X_j) C_j^-1 k_{j,*}, i != j
      [C_A]_ii = [k_A]_i
    (the Rulliere et al. / Bachoc et al. covariance Cov(mu_i, mu_j); the
    paper's eq. 19 literally reads C_ij C_ij^-1, a typo). Off-diagonal
    blocks use the noise-free K(X_i, X_j): measurement noise is iid across
    disjoint local datasets.

    The i = j Gram blocks are never formed (the diagonal is k_A), and
    [C_A]_ji = [C_A]_ij, so each of the M(M-1)/2 pairs i < j is assembled
    once, one (Ni, Nj) block at a time: the reference builds all M^2
    blocks at once (4.2 GB of float32 at the paper fleet). `Kcross`
    (M, M, Ni, Ni) (`cross_gram`, `fit_experts(cache_cross=True)`)
    replaces the per-call Gram assembly.
    """
    M = Xp.shape[0]
    ks = se_kernel(Xp, Xs[None], log_theta)                  # (M, Ni, Nt)
    W = cho_solve(L, ks)                                     # C_i^-1 k_i*
    mu = torch.einsum("mnt,mn->mt", ks, alpha)
    kA = (ks * W).sum(-2)                                    # (M, Nt)
    CA = torch.diag_embed(kA.T)                              # (Nt, M, M)
    for i in range(M):
        for j in range(i + 1, M):
            Kij = se_kernel(Xp[i], Xp[j], log_theta) if Kcross is None \
                else Kcross[i, j]
            c = (W[i] * (Kij @ W[j])).sum(0)                 # (Nt,)
            CA[:, i, j] = c
            CA[:, j, i] = c
    return mu, kA, CA


def local_moments(log_theta, Xp, yp, Xs, jitter=1e-8):
    """Per-call wrapper (factorize, then predict) for eq. 10-11."""
    L, alpha = chol_factors(log_theta, Xp, yp, jitter)
    return local_moments_cached(log_theta, Xp, L, alpha, Xs)


def npae_terms(log_theta, Xp, yp, Xs, jitter=1e-8):
    """Per-call wrapper around `npae_terms_cached` (see its docstring)."""
    L, alpha = chol_factors(log_theta, Xp, yp, jitter)
    return npae_terms_cached(log_theta, Xp, L, alpha, Xs)
