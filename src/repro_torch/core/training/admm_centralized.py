"""Centralized ADMM factorized GP training (paper §3): c-GP (eq. 24),
apx-GP (eq. 26, Xie et al. 2019) and gapx-GP (Alg. 1, apx-GP on the grBCM
augmented datasets); counterpart of `repro.core.training.admm_centralized`.

Agent-local quantities live on a leading agent axis (M, ...); the server
steps (z-update) are means over it. Local NLL gradients go through the
same `grad_fn` hook as the decentralized loops. The reference's scan is a
Python loop whose per-iteration series stay on the device.
"""
from __future__ import annotations

import torch

from .admm_decentralized import _init, _stack
from .cache import local_nll, make_local_grad


def _z_update(thetas, psis, rho):
    """z^{s+1} = (1/M) sum_i (theta_i + psi_i / rho)   (24a)/(26a)."""
    return (thetas + psis / rho).mean(0)


def _central_diag(thetas, z, z_prev, resid, rho, aux):
    """Per-iteration diagnostics of the centralized loops (diag=True):
    primal = max_i ||theta_i - z|| (the `residuals` quantity), dual =
    rho * max|z - z_prev|, per-agent NLL and the theta trajectory."""
    return {
        "residuals": resid,
        "primal_residuals": resid,
        "dual_residuals": rho * (z - z_prev).abs().max(),
        "nll": local_nll(thetas, aux),
        "theta_trajectory": thetas,
    }


def _central_loop(step, thetas, psis, rho, iters, aux, diag):
    """Run `step(thetas, psis) -> (z, thetas, psis)` `iters` times and
    assemble (z, thetas, info) as the reference does."""
    zs, ys = [], []
    z_prev = thetas[0]
    for _ in range(iters):
        z, thetas, psis = step(thetas, psis)
        resid = torch.linalg.norm(thetas - z, dim=1).max()
        ys.append(_central_diag(thetas, z, z_prev, resid, rho, aux)
                  if diag else resid)
        zs.append(z)
        z_prev = z
    zs, ys = torch.stack(zs), _stack(ys)
    if not diag:
        return zs[-1], thetas, {"z_history": zs, "residuals": ys}
    return zs[-1], thetas, {"z_history": zs, "residuals": ys["residuals"],
                            "diagnostics": dict(ys)}


def train_c_gp(log_theta0, Xp, yp, rho: float = 500.0, iters: int = 100,
               nested_iters: int = 10, nested_lr: float = 1e-5, grad_fn=None,
               diag: bool = False):
    """c-GP (eq. 24): exact consensus ADMM, nested GD per agent per round.

    Returns (z, thetas, info). The nested problem (24b) takes
    `nested_iters` plain GD steps (the paper's alpha = 1e-5), the local NLL
    gradient from the grad_fn hook and the penalty terms analytic.
    `diag=True` adds per-iteration primal/dual residuals, per-agent NLL and
    the theta trajectory under info["diagnostics"]."""
    thetas, psis = _init(log_theta0, Xp)
    prepare, lgrad = make_local_grad(grad_fn)
    aux = prepare(Xp, yp)                        # once per fit, NOT per iter

    def step(thetas, psis):
        z = _z_update(thetas, psis, rho)                        # (24a)
        th = thetas
        for _ in range(nested_iters):                           # (24b)
            th = th - nested_lr * (lgrad(th, aux) + psis + rho * (th - z))
        return z, th, psis + rho * (th - z)                     # (24c)
    return _central_loop(step, thetas, psis, rho, iters, aux, diag)


def train_apx_gp(log_theta0, Xp, yp, rho: float = 500.0, L: float = 5000.0,
                 iters: int = 100, grad_fn=None, diag: bool = False):
    """apx-GP (eq. 26): proximal ADMM with the analytic theta-update

    theta_i = z - (grad L_i(z) + psi_i) / (rho + L_i)   (26b)

    `diag=True` as in train_c_gp."""
    thetas, psis = _init(log_theta0, Xp)
    prepare, lgrad = make_local_grad(grad_fn)
    aux = prepare(Xp, yp)                        # once per fit, NOT per iter

    def step(thetas, psis):
        z = _z_update(thetas, psis, rho)                        # (26a)
        g = lgrad(z.expand_as(thetas), aux)                     # grad L_i(z)
        th = z - (g + psis) / (rho + L)                         # (26b)
        return z, th, psis + rho * (th - z)                     # (26c)
    return _central_loop(step, thetas, psis, rho, iters, aux, diag)



def train_gapx_gp(log_theta0, Xp_aug, yp_aug, rho: float = 500.0,
                  L: float = 5000.0, iters: int = 100, grad_fn=None,
                  diag: bool = False):
    """gapx-GP (Alg. 1): apx-GP on the augmented datasets D_{+i}, which the
    caller builds (core.gp.communication_dataset + augment: sample ->
    flood -> union)."""
    return train_apx_gp(log_theta0, Xp_aug, yp_aug, rho=rho, L=L,
                        iters=iters, grad_fn=grad_fn, diag=diag)
