"""Separable squared-exponential covariance (paper eq. 2).

Hyperparameters follow the paper: theta = (l_1, ..., l_D, sigma_f, sigma_eps),
all strictly positive, optimized as log(theta) (Remark 1). The paper's
convention has no factor of 2 in the denominator:
k(x,x') = sigma_f^2 exp{ -sum_d (x_d-x'_d)^2 / l_d^2 }.

Counterpart of `repro.core.gp.kernel`. Every function takes leading batch
dimensions (the agent axis) where the JAX package vmapped.
"""
from __future__ import annotations

import torch


def unpack(log_theta: torch.Tensor):
    """log_theta (D+2,) -> (lengthscales (D,), sigma_f, sigma_eps)."""
    theta = torch.exp(log_theta)
    return theta[:-2], theta[-2], theta[-1]


def pack(lengthscales, sigma_f, sigma_eps, *, dtype=None,
         device=None) -> torch.Tensor:
    """(l_1..l_D, sigma_f, sigma_eps) in linear space -> log_theta (D+2,)."""
    parts = [torch.atleast_1d(torch.as_tensor(p, dtype=dtype, device=device))
             for p in (lengthscales, sigma_f, sigma_eps)]
    return torch.log(torch.cat(parts))


def sq_dists(x1: torch.Tensor, x2: torch.Tensor,
             lengthscales: torch.Tensor) -> torch.Tensor:
    """Scaled squared distances sum_d (x1_d - x2_d)^2 / l_d^2.

    x1 (..., N, D), x2 (..., M, D) -> (..., N, M), clamped at 0. The
    ||a||^2 + ||b||^2 - 2 a.b expansion is the reference's form, kept so
    the two packages round alike.
    """
    a = x1 / lengthscales
    b = x2 / lengthscales
    d2 = ((a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :]
          - 2.0 * a @ b.transpose(-1, -2))
    return torch.clamp(d2, min=0.0)


def se_kernel(x1: torch.Tensor, x2: torch.Tensor,
              log_theta: torch.Tensor) -> torch.Tensor:
    """k(x1, x2) for x1 (..., N, D), x2 (..., M, D) -> (..., N, M)."""
    ls, sigma_f, _ = unpack(log_theta)
    return sigma_f**2 * torch.exp(-sq_dists(x1, x2, ls))


def cov_matrix(X: torch.Tensor, log_theta: torch.Tensor,
               jitter: float = 0.0) -> torch.Tensor:
    """C_theta = K + (sigma_eps^2 + jitter) I for X (..., N, D)."""
    _, _, sigma_eps = unpack(log_theta)
    K = se_kernel(X, X, log_theta)
    eye = torch.eye(X.shape[-2], dtype=K.dtype, device=K.device)
    return K + (sigma_eps**2 + jitter) * eye
