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
