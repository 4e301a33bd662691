"""Sparse variational training, counterpart of `repro.core.sparse.trainer`:
the Titsias collapsed bound as a drop-in local objective for both trainer
families.

  fact-sparse     — centralized FACT-GP workflow on the summed collapsed
                    bounds, jointly over the hyperparameters AND the
                    inducing inputs Z (Adam).
  dec-apx-sparse  — decentralized ADMM (train_dec_apx_gp) with the local
                    NLL gradient swapped for the collapsed-bound gradient
                    through the `grad_fn` hook: each agent takes a strided
                    subset of its own data as Z, so the eq. (34) update and
                    the consensus structure are untouched.

The bound (Titsias 2009, in the paper's kernel convention, as a negative
log-likelihood to minimize):

  -ELBO_i = N/2 log 2pi + sum log diag(LB) + N log sigma_eps
            + (y^T y - c^T c)/(2 sigma_eps^2)            [data fit]
            + (tr(Knn) - tr(A A^T)) / (2 sigma_eps^2)    [Qnn correction]

with A = Lm^-1 Kmn, B = I + A A^T / sigma_eps^2, LB = chol(B),
c = LB^-1 A y, tr(Knn) = N sigma_f^2. At m = Ni the correction vanishes
and the bound equals the exact NLL. Gradients come from torch.autograd,
as the reference's from jax.grad.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...optim import adam, apply_updates
from ..gp.kernel import se_kernel, unpack
from ..gp.nll import cholesky
from .experts import _rel_jitter, _tri


def sparse_nll(log_theta, Z, Xi, yi, jitter: float = 1e-8):
    """Negative collapsed bound of one agent: Z (m, D), Xi (N, D), yi (N,)
    -> scalar; leading batch dimensions (the agent axis) on Z, Xi, yi give
    one value per agent.

    Differentiable in both log_theta and Z, O(N m^2) per evaluation, no
    (N, N) matrix anywhere.
    """
    _, sigma_f, sigma_eps = unpack(log_theta)
    N, m = Xi.shape[-2], Z.shape[-2]
    dtype = Xi.dtype
    eye = torch.eye(m, dtype=dtype, device=Xi.device)
    Kmm = se_kernel(Z, Z, log_theta)
    Lm = cholesky(Kmm + _rel_jitter(sigma_f, dtype, jitter) * eye)
    A = _tri(Lm, se_kernel(Z, Xi, log_theta))                  # (m, N)
    LB = cholesky(eye + (A @ A.mT) / sigma_eps**2)
    cb = _tri(LB, A @ yi[..., None])[..., 0]
    data_fit = ((yi * yi).sum(-1) - (cb * cb).sum(-1) / sigma_eps**2) \
        / (2.0 * sigma_eps**2)
    qnn_corr = (N * sigma_f**2 - (A * A).sum((-2, -1))) \
        / (2.0 * sigma_eps**2)
    return (0.5 * N * math.log(2.0 * math.pi)
            + torch.log(torch.diagonal(LB, dim1=-2, dim2=-1)).sum(-1)
            + N * torch.log(sigma_eps) + data_fit + qnn_corr)


def sparse_nlls(log_theta, Z, Xp, yp, jitter: float = 1e-8):
    """-ELBO_i per agent (M,) with shared theta and per-agent Z (M, m, D)."""
    return sparse_nll(log_theta, Z, Xp, yp, jitter)


def train_fact_sparse(log_theta0, Xp, yp, Z0, steps: int = 200,
                      lr: float = 0.05, jitter: float = 1e-8):
    """fact-sparse: centralized Adam on sum_i -ELBO_i, jointly over the
    shared log_theta and every agent's inducing inputs Z (M, m, D).

    Returns (log_theta, Z, vals) with vals (steps,) the summed bound before
    each step (GPFleet surfaces it as info["nll"]).
    """
    opt = adam(lr, state_dtype=log_theta0.dtype)
    params = {"log_theta": log_theta0.detach(), "Z": Z0.detach()}
    st = opt.init(params)
    vals = []
    for _ in range(steps):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            val = sparse_nlls(leaves["log_theta"], leaves["Z"], Xp, yp,
                              jitter).sum()
            g_lt, g_Z = torch.autograd.grad(val, (leaves["log_theta"],
                                                  leaves["Z"]))
        upd, st = opt.update({"log_theta": g_lt, "Z": g_Z}, st, params)
        params = apply_updates(params, upd)
        vals.append(val.detach())
    return params["log_theta"], params["Z"], torch.stack(vals)


def make_sparse_grad(m: int, jitter: float = 1e-8):
    """Per-agent gradient for the ADMM `grad_fn` hook (dec-apx-sparse):
    d(-ELBO_i)/dlog_theta with Z_i a strided subset of the agent's own data
    (deterministic and agent-local; `inducing_init` affects only the
    serving-time Z). Signature of the hook's custom-callable form:
    (log_theta (D+2,), Xi (N, D), yi (N,)) -> (D+2,).
    """
    def grad_one(log_theta, Xi, yi):
        N = Xi.shape[0]
        idx = np.round(np.linspace(0, N - 1, min(int(m), N))).astype(np.int64)
        Z = Xi[torch.from_numpy(idx).to(Xi.device)]
        lt = log_theta.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(sparse_nll(lt, Z, Xi, yi, jitter),
                                       lt)
        return g

    return grad_one
