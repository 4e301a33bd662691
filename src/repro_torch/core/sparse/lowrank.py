"""Low-rank NPAE from sparse factors, counterpart of
`repro.core.sparse.lowrank`.

Dense NPAE needs every cross-agent Gram block K(X_i, X_j), O(M^2 Ni^2).
With sparse experts the cross-covariance of the expert means is low-rank:
per query t and agents i, j

  [C_A]_ij[t] = U_i[:, t]^T  K(Z_i, Z_j)  U_j[:, t],
  U_i = (Kmm_i^-1 - Sigma_i^-1) k(Z_i, x_t)          (m, q) per agent,

a double Nystroem through the pseudo-points: O(M^2 m^2) per query, and
each agent contributes only its (m, q) factor U_i and its m inducing
points. The diagonal is the exact local k_A, and the per-query solve is
`aggregation.npae`, the same core as the exact family.

`aggregation` is imported inside `dec_npae_sparse`: prediction.engine
imports this package, so a module-level import would cycle.
"""
from __future__ import annotations

import torch

from ..gp.kernel import se_kernel
from ..gp.nll import cho_solve
from .experts import (SparseExperts, fit_sparse_experts,
                      select_inducing)


def sparse_npae_factors(log_theta, Z, Lmm, LS, c, Xs):
    """Per-agent low-rank NPAE factors at the query tile Xs (Nt, D).

    Returns (mu (M, Nt), kA (M, Nt), U (M, m, Nt)) with
    U_i = (Kmm^-1 - Sigma^-1) k(Z_i, Xs) and kA_i = k^T U_i.
    """
    ks = se_kernel(Z, Xs[None], log_theta)                      # (M, m, Nt)
    U = cho_solve(Lmm, ks) - cho_solve(LS, ks)
    kA = (ks * U).sum(-2)
    return torch.einsum("mnt,mn->mt", ks, c), kA, U


def cross_lowrank(log_theta, Z, U, kA):
    """Assemble C_A (Nt, M, M) from the agents' factors: off-diagonals by
    the double Nystroem U_i^T K(Z_i, Z_j) U_j, the diagonal set to the exact
    local k_A."""
    M = Z.shape[0]
    Kij = se_kernel(Z[:, None], Z[None, :], log_theta)        # (M, M, m, m)
    CA = torch.einsum("iat,ijab,jbt->tij", U, Kij, U)
    idx = torch.arange(M, device=Z.device)
    CA[:, idx, idx] = kA.T
    return CA


def npae_terms_lowrank(log_theta, Z, Lmm, LS, c, Xs):
    """NPAE aggregation terms from sparse factors at O(M^2 m^2) per query.
    Returns (mu (M, Nt), kA (M, Nt), CA (Nt, M, M))."""
    mu, kA, U = sparse_npae_factors(log_theta, Z, Lmm, LS, c, Xs)
    return mu, kA, cross_lowrank(log_theta, Z, U, kA)


def dec_npae_sparse(log_theta, Xp, yp, Xs, m: int,
                    inducing_init: str = "stride", jitter: float = 1e-8,
                    npae_jitter: float = 1e-6, seed: int = 0,
                    experts: SparseExperts | None = None):
    """Per-call reference wrapper: sparse NPAE on raw data (fit and predict
    in one call). Pass `experts` to reuse already-fitted factors.
    Returns (mean (Nt,), var (Nt,))."""
    from ..prediction.aggregation import npae
    f = experts
    if f is None:
        Z = select_inducing(Xp, m, inducing_init, seed)
        f = fit_sparse_experts(log_theta, Xp, yp, Z, jitter=jitter)
    mu, kA, CA = npae_terms_lowrank(f.log_theta, f.Z, f.Lmm, f.LS, f.c, Xs)
    return npae(mu, kA, CA, f.prior_var, jitter=npae_jitter)
