"""Factorized GP training (paper §2.3.1, P2): FACT-GP, counterpart of
`repro.core.training.factorized`.

Under Assumption 4 the global NLL factorizes as a sum of local NLLs. The
server runs Adam on sum_i NLL_i, every agent contributing its local
gradient each round (Xie et al. 2019 workflow). Gradients come from
autograd through the Cholesky, as the reference's jax.value_and_grad.
"""
from __future__ import annotations

import torch

from ...optim import adam, apply_updates
from ..gp.nll import nll, value_and_grad


def local_nlls(log_theta, Xp, yp):
    """NLL_i of each agent at a shared theta. Xp (M, Ni, D), yp (M, Ni)."""
    return nll(log_theta, Xp, yp)


def factorized_nll(log_theta, Xp, yp):
    """sum_i NLL_i — the P2 objective."""
    return local_nlls(log_theta, Xp, yp).sum()


def train_fact_gp(log_theta0, Xp, yp, steps: int = 200, lr: float = 0.05):
    """FACT-GP: centralized Adam on the factorized objective.

    Returns (log_theta, the objective before each step (steps,))."""
    lt = torch.as_tensor(log_theta0, device=Xp.device)
    opt = adam(lr, state_dtype=lt.dtype)
    st = opt.init(lt)
    vals = []
    for _ in range(steps):
        val, g = value_and_grad(factorized_nll, lt, Xp, yp)
        upd, st = opt.update(g, st, lt)
        lt = apply_updates(lt, upd)
        vals.append(val)
    return lt, torch.stack(vals)
