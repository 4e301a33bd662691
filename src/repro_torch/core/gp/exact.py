"""FULL-GP: exact training (P1) with multi-start Adam on log-theta, and exact
prediction (paper eq. 5-6).

Counterpart of `repro.core.gp.exact`. The reference reaches no Pallas
kernel here (`jnp.linalg` and `jax.value_and_grad`), so neither does the
port: `torch.linalg` Cholesky and triangular solves, and autograd. The
data's device is where everything runs; the extra starts of
`train_full_gp` come from a `torch.Generator`.
"""
from __future__ import annotations

import torch

from ...optim import adam, apply_updates
from .kernel import cov_matrix, se_kernel, unpack
from .nll import cho_solve, cholesky, nll, value_and_grad


def _fit_one(log_theta0, X, y, steps: int = 200, lr: float = 0.05):
    """`steps` Adam steps on the NLL from `log_theta0`.

    Returns (log_theta, its NLL, the NLL before each step (steps,))."""
    opt = adam(lr, state_dtype=log_theta0.dtype)
    lt, st = log_theta0, opt.init(log_theta0)
    vals = []
    for _ in range(steps):
        val, g = value_and_grad(nll, lt, X, y)
        upd, st = opt.update(g, st, lt)
        lt = apply_updates(lt, upd)
        vals.append(val)
    hist = torch.stack(vals) if vals else X.new_zeros(0)
    return lt, nll(lt, X, y).detach(), hist


def train_full_gp(X, y, generator: torch.Generator | None = None,
                  num_starts: int = 3, steps: int = 200, lr: float = 0.05,
                  log_theta0=None):
    """Multi-start MLE (paper Remark 6 / Chen & Wang 2018). Returns the best
    log-theta and {"nll": its NLL, "history": its per-step NLL}.

    The first start is `log_theta0` (default zeros); each further start
    adds 0.5 N(0, I) drawn from `generator` (default: a fresh generator
    on X's device seeded 0), so the starts are not the reference's
    `jax.random` draws."""
    D = X.shape[1]
    if log_theta0 is None:
        log_theta0 = torch.zeros(D + 2, dtype=X.dtype, device=X.device)
    if generator is None:
        generator = torch.Generator(X.device).manual_seed(0)
    starts = [log_theta0] + [
        log_theta0 + 0.5 * torch.randn(D + 2, generator=generator,
                                       dtype=X.dtype, device=X.device)
        for _ in range(num_starts - 1)]
    results = [_fit_one(s, X, y, steps=steps, lr=lr) for s in starts]
    best = min(range(len(results)), key=lambda i: float(results[i][1]))
    lt, val, history = results[best]
    return lt, {"nll": val, "history": history}


def predict_full(log_theta, X, y, Xs, jitter: float = 1e-8):
    """Exact GP posterior mean/var at test inputs Xs (paper eq. 5-6).

    `jitter` is absolute, as in the reference. A Cholesky that fails
    gives NaN (the reference's behaviour), not an exception."""
    C = cov_matrix(X, log_theta, jitter=jitter)
    L = cholesky(C)
    del C                      # 4.2 GB at 32,400 float32 points
    ks = se_kernel(X, Xs, log_theta)              # (N, Nt)
    mean = ks.T @ cho_solve(L, y)
    v = torch.linalg.solve_triangular(L, ks, upper=False)
    _, sigma_f, _ = unpack(log_theta)
    var = sigma_f**2 - (v * v).sum(0)
    return mean, torch.clamp(var, min=1e-12)
