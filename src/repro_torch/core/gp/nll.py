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

from ...obs.metrics import default_registry
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


def _tri_inv(L: torch.Tensor, X: torch.Tensor, edge: int):
    """X <- L^-1 for lower L (B, n, n), X zeroed: with L = [[A, 0], [B, C]],
    the inverses X11, X22 of A and C by recursion, then X21 = -X22 B X11 by
    two triangle-aware products; the n^3/3 flops of LAPACK's trtri."""
    n = L.shape[-1]
    if n <= edge:
        eye = torch.eye(n, dtype=L.dtype, device=L.device)
        X.copy_(torch.linalg.solve_triangular(L, eye.expand_as(L),
                                              upper=False))
        return
    h = n // 2
    X11, X21, X22 = X[:, :h, :h], X[:, h:, :h], X[:, h:, h:]
    _tri_inv(L[:, :h, :h], X11, edge)
    _tri_inv(L[:, h:, h:], X22, edge)
    X22B = torch.empty_like(X21)
    _trmm(X22, L[:, h:, :h], X22B, edge, left=True)
    _trmm(X11, X22B, X21, edge, left=False)
    X21.neg_()


def _trmm(R: torch.Tensor, Q: torch.Tensor, out: torch.Tensor, edge: int,
          left: bool):
    """out <- R Q (left) or Q R for lower R (B, n, n), in half the flops of
    one product: R = [[R11, 0], [R21, R22]] split as `_tri_inv` splits."""
    n = R.shape[-1]
    if n <= edge:
        if left:
            torch.matmul(R, Q, out=out)
        else:
            torch.matmul(Q, R, out=out)
        return
    h = n // 2
    R11, R21, R22 = R[:, :h, :h], R[:, h:, :h], R[:, h:, h:]
    if left:     # [R11 Q1; R21 Q1 + R22 Q2]
        _trmm(R22, Q[:, h:], out[:, h:], edge, left)
        out[:, h:].baddbmm_(R21, Q[:, :h])
        _trmm(R11, Q[:, :h], out[:, :h], edge, left)
    else:        # [Q1 R11 + Q2 R21, Q2 R22]
        _trmm(R11, Q[..., :h], out[..., :h], edge, left)
        out[..., :h].baddbmm_(Q[..., h:], R21)
        _trmm(R22, Q[..., h:], out[..., h:], edge, left)


def _syrk(Q: torch.Tensor, S: torch.Tensor, edge: int):
    """S += Q^T Q for Q (B, k, m), on and below S's diagonal blocks only:
    half the flops of one product."""
    m = Q.shape[-1]
    if m <= edge:
        S.baddbmm_(Q.mT, Q)
        return
    h = m // 2
    Q1, Q2 = Q[..., :h], Q[..., h:]
    _syrk(Q1, S[:, :h, :h], edge)
    S[:, h:, :h].baddbmm_(Q2.mT, Q1)
    _syrk(Q2, S[:, h:, h:], edge)


def _lauum(X: torch.Tensor, S: torch.Tensor, edge: int):
    """S <- X^T X for lower X (B, n, n), on and below S's diagonal blocks
    only: with X = [[P, 0], [Q, R]], S11 = P^T P + Q^T Q, S21 = R^T Q =
    (Q^T R)^T, S22 = R^T R; the n^3/3 flops of LAPACK's lauum."""
    n = X.shape[-1]
    if n <= edge:
        torch.matmul(X.mT, X, out=S)
        return
    h = n // 2
    P, Q, R = X[:, :h, :h], X[:, h:, :h], X[:, h:, h:]
    _lauum(P, S[:, :h, :h], edge)
    _syrk(Q, S[:, :h, :h], edge)
    _trmm(R, Q.mT, S[:, h:, :h].mT, edge, left=False)
    _lauum(R, S[:, h:, h:], edge)


def _inner_blocked(L: torch.Tensor, y: torch.Tensor, edge: int):
    """inner from lower L (..., n, n) with n > edge: C^-1 = L^-T L^-1 by
    `_tri_inv` then `_lauum`, as LAPACK's potri splits it, its lower
    triangle mirrored, so inner is exactly symmetric."""
    n = L.shape[-1]
    Lb = L.reshape(-1, n, n)
    X = torch.zeros(Lb.shape, dtype=L.dtype, device=L.device)
    S = torch.empty_like(X)
    _tri_inv(Lb, X, edge)
    _lauum(X, S, edge)
    lower = torch.ones(n, n, dtype=torch.bool, device=L.device).tril_()
    inner = torch.where(lower, S, S.mT, out=X)
    alpha = inner @ y.expand(L.shape[:-1]).reshape(-1, n, 1)
    return inner.addcmul_(alpha, alpha.mT, value=-1).reshape(L.shape)


# Above this many points an agent's C^-1 is built by `_inner_blocked`
INVERSE_EDGE = 1024


def inner_from_cov(C: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """inner = C^-1 - alpha alpha^T, the trace-identity operand of eq. 4,
    shared by `nll_grad_analytic` and the fused cached path.

    The gradient reads every entry of C^-1, so it is built whole, from the
    Cholesky factor L, by one of two routes chosen by the agents' size N
    (`_inner_from_factor`):

      direct  (N <= INVERSE_EDGE): L^-1 by a triangular solve against the
              identity, C^-1 = L^-T L^-1 by one product; 3n^3 flops, the
              reference's cho_solve against the identity.
      blocked (N > INVERSE_EDGE): L^-1, then L^-T L^-1, by blocked
              recursion on their triangles (n^3/3 flops each, as LAPACK's
              potri), in GEMMs down to blocks of at most INVERSE_EDGE,
              which take the direct route's calls: two ninths of its
              flops, in float32 library calls too. The block of L^-1
              below its diagonal blocks is -X22 B X11, from the inverted
              diagonal blocks, not two solves on L's own blocks: on the
              card cuBLAS's right-side solve ran at a fraction of its
              products' rate, and the whole inner took 98 ms by solves, 58
              by products (PERF.md).

    Times on the card of four 8,100-point agents' C^-1 by the library
    routes (chip_smoke.py's train phase, two runs): torch.cholesky_inverse
    240.9 / 223.9 ms, torch.cholesky_solve(I) 229.4 / 234.2 ms, the direct
    route 152.4 / 153.5 ms; the first two also run full-size solves or
    products. PERF.md has the blocked route's. A failed factor is NaN and
    gives a NaN inner by either route."""
    with span("train.factor"):
        L = cholesky(C)
    with span("train.inverse"):
        return _inner_from_factor(L, y, INVERSE_EDGE)


def _inner_from_factor(L: torch.Tensor, y: torch.Tensor, edge: int):
    """inner from the lower factor L (..., N, N): blocked above `edge`,
    direct at or below it; `gp_inner_from_cov_total` counts the calls by
    route (a host-side increment)."""
    blocked = L.shape[-1] > edge
    default_registry().counter(
        "gp_inner_from_cov_total", "inner_from_cov calls by route").inc(
            route="blocked" if blocked else "direct")
    if blocked:
        return _inner_blocked(L, y, edge)
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
