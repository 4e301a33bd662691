"""Separable squared-exponential covariance (paper eq. 2).

Hyperparameters follow the paper: theta = (l_1, ..., l_D, sigma_f, sigma_eps),
all strictly positive, optimized as log(theta) (Remark 1). The paper's
convention has no factor of 2 in the denominator:
k(x,x') = sigma_f^2 exp{ -sum_d (x_d-x'_d)^2 / l_d^2 }.

Counterpart of `repro.core.gp.kernel`. Every function takes leading batch
dimensions (the agent axis) where the JAX package vmapped; `log_theta` is
either one shared (D+2,) vector or carries the same leading dimensions as
the inputs (one row per agent).
"""
from __future__ import annotations

import torch


def unpack(log_theta: torch.Tensor):
    """log_theta (..., D+2) -> (lengthscales (..., D), sigma_f (...),
    sigma_eps (...))."""
    theta = torch.exp(log_theta)
    return theta[..., :-2], theta[..., -2], theta[..., -1]


def pack(lengthscales, sigma_f, sigma_eps, *, dtype=None,
         device=None) -> torch.Tensor:
    """(l_1..l_D, sigma_f, sigma_eps) in linear space -> log_theta (D+2,)."""
    parts = [torch.atleast_1d(torch.as_tensor(p, dtype=dtype, device=device))
             for p in (lengthscales, sigma_f, sigma_eps)]
    return torch.log(torch.cat(parts))


def sq_dists(x1: torch.Tensor, x2: torch.Tensor,
             lengthscales: torch.Tensor) -> torch.Tensor:
    """Scaled squared distances sum_d (x1_d - x2_d)^2 / l_d^2.

    x1 (..., N, D), x2 (..., M, D), lengthscales (D,) or (..., D) ->
    (..., N, M), clamped at 0. The
    ||a||^2 + ||b||^2 - 2 a.b expansion is the reference's form, kept so
    the two packages round alike.
    """
    ls = lengthscales[..., None, :]
    a = x1 / ls
    b = x2 / ls
    d2 = ((a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :]
          - 2.0 * a @ b.transpose(-1, -2))
    return torch.clamp(d2, min=0.0)


def se_kernel(x1: torch.Tensor, x2: torch.Tensor,
              log_theta: torch.Tensor) -> torch.Tensor:
    """k(x1, x2) for x1 (..., N, D), x2 (..., M, D) -> (..., N, M)."""
    ls, sigma_f, _ = unpack(log_theta)
    return sigma_f[..., None, None]**2 * torch.exp(-sq_dists(x1, x2, ls))


def cov_matrix(X: torch.Tensor, log_theta: torch.Tensor,
               jitter=0.0) -> torch.Tensor:
    """C_theta = K + (sigma_eps^2 + jitter) I for X (..., N, D).

    `jitter` is a float or a tensor with log_theta's batch dimensions
    (gp.nll.effective_jitter). The diagonal is added in place, so no
    (..., N, N) identity is formed."""
    _, _, sigma_eps = unpack(log_theta)
    K = se_kernel(X, X, log_theta)
    K.diagonal(dim1=-2, dim2=-1).add_((sigma_eps**2 + jitter)[..., None])
    return K


def diff2_stack(X: torch.Tensor) -> torch.Tensor:
    """Unscaled per-dimension squared differences (x_d - x'_d)^2.

    X (..., N, D) -> (..., D, N, N). Pure geometry, independent of theta,
    so training builds it once per fit (core.training.cache). Exact outer
    differences, not the ||x||^2 - 2 x x^T expansion of `sq_dists`: each
    dimension is rank one, and the direct form has no cancellation.
    """
    Xt = X.transpose(-1, -2).contiguous()                  # (..., D, N)
    return ((Xt[..., :, :, None] - Xt[..., :, None, :]) ** 2).contiguous()


def cov_grads(X: torch.Tensor, log_theta: torch.Tensor) -> torch.Tensor:
    """Analytic dC/dtheta_j, stacked (..., D+2, N, N) (paper Appendix A.1).

    Derivatives are with respect to the raw theta, not log theta; the chain
    rule to log-params is d/dlog_theta_j = theta_j d/dtheta_j. The slow
    reference path: it materializes the whole derivative stack, which the
    training path (kernels.ops.nll_grad_fused) never builds.
    """
    ls, sigma_f, sigma_eps = unpack(log_theta)
    K = se_kernel(X, X, log_theta)
    n = X.shape[-2]
    g_ls = (2.0 / ls**3)[..., :, None, None] * K[..., None, :, :] \
        * diff2_stack(X)
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    return torch.cat([
        g_ls,
        (2.0 * K / sigma_f[..., None, None])[..., None, :, :],
        (2.0 * sigma_eps[..., None, None] * eye)[..., None, :, :]
        .expand(*K.shape[:-2], 1, n, n),
    ], dim=-3)
