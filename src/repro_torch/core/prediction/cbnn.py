"""Covariance-based nearest-neighbor agent selection (paper §5.2, eq. 39).

[k_mu,*]_i = k_{i,*}^T C_i^-1 k_{i,*} measures the statistical correlation
of agent i's dataset to the query point; agents below eta_NN sit out the
aggregation. Computed from purely local quantities (Assumption 2 holds).
Eq. 39 coincides with the NPAE term k_A (eq. 18), and the score equals
sigma_f^2 - var_i: CBNN selects exactly the agents whose local posterior
variance at the query is smallest.

Counterpart of `repro.core.prediction.cbnn`:
  cbnn_scores_cached / cbnn_mask_cached — factor-cached (engine serving)
  cbnn_scores / cbnn_mask               — per-call wrappers (refactorize)

The score is |L_i^-1 k_{i,*}|^2: one triangular solve, the same quantity
as the reference's k^T (L L^T)^-1 k from two.
"""
from __future__ import annotations

import torch

from ..gp.kernel import se_kernel
from .local import chol


def cbnn_scores_cached(log_theta, Xp, L, Xs):
    """(M, Nt) correlation scores [k_mu,*]_i (eq. 39) from precomputed
    factors (no refactorization per call)."""
    v = torch.linalg.solve_triangular(L, se_kernel(Xp, Xs[None], log_theta),
                                      upper=False)
    return (v * v).sum(-2)


def _mask_from_scores(scores, eta_nn: float):
    """Threshold scores (eq. 39); guarantee >= 1 agent per query.

    The guarantee keeps every agent achieving the per-query maximum score
    (ties keep all tied agents): max-equality rather than argmax, as the
    reference does so its sharded engine can reproduce the mask from
    shard-local scores plus one exact ring max."""
    best = scores >= scores.amax(0, keepdim=True)
    return (scores >= eta_nn) | best


def cbnn_mask_cached(log_theta, Xp, L, Xs, eta_nn: float):
    """Boolean participation mask (M, Nt) from precomputed factors;
    returns (mask, scores)."""
    scores = cbnn_scores_cached(log_theta, Xp, L, Xs)
    return _mask_from_scores(scores, eta_nn), scores


def cbnn_scores(log_theta, Xp, Xs, jitter=1e-8):
    """(M, Nt) scores per agent per query. Per-call wrapper: factorizes
    every agent, then scores."""
    return cbnn_scores_cached(log_theta, Xp, chol(Xp, log_theta, jitter), Xs)


def cbnn_mask(log_theta, Xp, Xs, eta_nn: float, jitter=1e-8):
    """Boolean participation mask (M, Nt) (eq. 39 thresholded at eta_nn);
    guarantees >= 1 agent per query. Per-call wrapper."""
    scores = cbnn_scores(log_theta, Xp, Xs, jitter)
    return _mask_from_scores(scores, eta_nn), scores
