"""Plain PyTorch oracles for the kernels (counterpart of repro.kernels.ref).

They materialize the Gram matrix and are ground truth for allclose tests.
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
