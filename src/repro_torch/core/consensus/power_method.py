"""Power method / inverse power method (paper eq. 37, Alg. 11) to recover
the optimal JOR relaxation factor omega* (Lemma 3) over a network.

Counterpart of `repro.core.consensus.power_method`, batched over leading
dimensions of R (one system per query in DEC-NPAE*). PM estimates
lambda_max(R); the spectral shift B = R - lambda_max I is fed back
through PM to get lambda_max(B), whence lambda_min(R) = |lambda_max(B) -
lambda_max(R)| for symmetric R with real spectrum.
"""
from __future__ import annotations

import torch


def power_method(R, iters: int = 200):
    """R (..., M, M) -> (lambda_max estimate (...), residual trajectory
    (..., iters)): the infinity norm of R e at each step."""
    M = R.shape[-1]
    batch = R.shape[:-2]
    R3 = R.reshape(-1, M, M)
    e = torch.full((R3.shape[0], M, 1), 1.0 / M, dtype=R.dtype,
                   device=R.device)
    ginfs = R.new_empty((iters, R3.shape[0]))
    one = R.new_ones(())
    for s in range(iters):
        g = torch.bmm(R3, e)
        ginf = torch.linalg.vector_norm(g, float("inf"), dim=(-2, -1),
                                        out=ginfs[s])
        # a zero iterate (R has an empty/zero spectrum side, e.g. the
        # shifted B of a 1x1 or identity R) must report lambda = 0, not
        # propagate 0/0 = NaN through the omega* formula
        e = g / torch.where(ginf > 0.0, ginf, one)[:, None, None]
    ginfs = ginfs.T.reshape(*batch, iters)
    return ginfs[..., -1], ginfs


def extreme_eigs(R, iters: int = 200):
    """(lambda_max, lambda_min) of symmetric R via PM + spectral shift
    (Alg. 12)."""
    lam_max, _ = power_method(R, iters)
    eye = torch.eye(R.shape[-1], dtype=R.dtype, device=R.device)
    lam_b, _ = power_method(R - lam_max[..., None, None] * eye, iters)
    return lam_max, torch.abs(lam_b - lam_max)


def optimal_omega(H, iters: int = 200):
    """omega* = 2 / (lmax(R) + lmin(R)), R = diag(H)^-1 H (Lemma 3)."""
    R = H / torch.diagonal(H, dim1=-2, dim2=-1)[..., :, None]
    lam_max, lam_min = extreme_eigs(R, iters)
    return 2.0 / (lam_max + lam_min)
