"""Negative marginal log-likelihood (paper P1) and its gradients (eq. 4).

Counterpart of `repro.core.gp.nll`. Every function takes leading batch
dimensions (the agent axis), with `log_theta` either shared (D+2,) or one
row per agent.

A float32 factorization that fails gives NaN, as `jnp.linalg.cholesky`
does in the reference: `torch.linalg.cholesky` would raise instead, and
its error check waits on the device every call. `cholesky` below takes
`torch.linalg.cholesky_ex` and masks a failed factor with NaN on the
device, so a training loop never waits on the host and a bad iterate
propagates as NaN exactly as in the reference.
"""
from __future__ import annotations

import math

import torch

from ...obs.tracing import span
from .kernel import cov_grads, cov_matrix

LOG_2PI = math.log(2.0 * math.pi)


def effective_jitter(log_theta: torch.Tensor, dtype, jitter: float = 1e-8):
    """Dtype-aware factorization jitter: relative, floored at 8*eps(dtype).

    `jitter` is relative to the prior diagonal sigma_f^2 + sigma_eps^2 and
    floored at 8*eps(dtype), so a float32 Cholesky is actually guarded.
    The scale is computed on a DETACHED theta: the guard is a numerical
    device, not part of the model, so autograd and the trace-identity
    gradients (analytic and fused) optimize the same objective. Returns
    log_theta's batch shape.
    """
    theta = torch.exp(log_theta.detach())
    scale = theta[..., -2] ** 2 + theta[..., -1] ** 2
    # the relative jitter is a `dtype` number, as in the reference
    rel = float(torch.tensor(max(jitter, 8 * torch.finfo(dtype).eps),
                             dtype=dtype))
    return rel * scale


def cholesky(C: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of C (..., N, N); a factor that fails is NaN
    (the reference's behaviour), with no host wait."""
    L, info = torch.linalg.cholesky_ex(C)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1 b for lower L (..., N, N), b (..., N) or (..., N, K):
    two triangular solves, the reference's cho_solve. Not
    torch.cholesky_solve: on an H100 it raised "invalid argument" for a
    float64 batch of four 8,100-point agents, one agent at a time it did
    not (ROADMAP C5)."""
    vec = b.dim() == L.dim() - 1
    B = b[..., None] if vec else b
    X = torch.linalg.solve_triangular(
        L.mT, torch.linalg.solve_triangular(L, B, upper=False), upper=True)
    return X[..., 0] if vec else X


def nll_from_cov(C: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """NLL given an already-built covariance C — the one Cholesky body
    shared by `nll` and the cached-geometry path (core.training.cache)."""
    n = y.shape[-1]
    L = cholesky(C)
    alpha = cho_solve(L, y)
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return 0.5 * ((y * alpha).sum(-1) + logdet + n * LOG_2PI)


def inner_from_cov(C: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """inner = C^-1 - alpha alpha^T, the trace-identity operand of eq. 4,
    shared by `nll_grad_analytic` and the fused cached path.

    C^-1 = L^-T L^-1 from one triangular solve against the identity and
    one matrix product: the reference's cho_solve against the identity in
    other words. On the card it is the faster of the three library routes
    (chip_smoke.py's train phase times it against torch.cholesky_solve
    and torch.cholesky_inverse; PERF.md has the numbers)."""
    with span("train.factor"):
        L = cholesky(C)
    with span("train.inverse"):
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
        Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
        Cinv = Linv.mT @ Linv
        alpha = (Cinv @ y[..., None])[..., 0]
        return Cinv - alpha[..., :, None] * alpha[..., None, :]


def nll(log_theta: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
        jitter: float = 1e-8) -> torch.Tensor:
    """0.5 (y^T C^-1 y + log|C| + N log 2pi) via Cholesky (Rasmussen A.4).

    `jitter` is relative with an 8*eps(dtype) floor — see effective_jitter.
    """
    C = cov_matrix(X, log_theta,
                   jitter=effective_jitter(log_theta, X.dtype, jitter))
    return nll_from_cov(C, y)


def value_and_grad(fn, log_theta: torch.Tensor, *args, **kw):
    """(fn(log_theta, ...), d sum(fn) / d log_theta) by autograd.

    With a batch of thetas the sum separates, so each row gets its own
    gradient. Both results are detached."""
    lt = log_theta.detach().requires_grad_(True)
    with torch.enable_grad():
        val = fn(lt, *args, **kw)
        (g,) = torch.autograd.grad(val.sum(), lt)
    return val.detach(), g


def nll_value_and_grad(log_theta: torch.Tensor, X: torch.Tensor,
                       y: torch.Tensor, jitter: float = 1e-8):
    """(nll, d nll / d log_theta) by autograd: the reference's
    `jax.value_and_grad(nll)`."""
    return value_and_grad(nll, log_theta, X, y, jitter=jitter)


def nll_grad_analytic(log_theta: torch.Tensor, X: torch.Tensor,
                      y: torch.Tensor, jitter: float = 1e-8) -> torch.Tensor:
    """Gradient via the paper's trace identity (eq. 4), in log-theta coords.

    dNLL/dtheta_j = 0.5 tr{ (C^-1 - C^-1 y y^T C^-1) dC/dtheta_j }.
    The slow reference path: it materializes the (D+2, N, N) derivative
    stack. Training uses the cached-geometry fused path instead
    (core.training.cache.nll_grad_cached -> kernels.ops.nll_grad_fused).
    """
    C = cov_matrix(X, log_theta,
                   jitter=effective_jitter(log_theta, X.dtype, jitter))
    inner = inner_from_cov(C, y)
    dC = cov_grads(X, log_theta)             # (..., D+2, N, N), raw theta
    g_raw = 0.5 * torch.einsum("...ij,...kji->...k", inner, dC)
    return g_raw * torch.exp(log_theta)      # chain rule to log-theta
