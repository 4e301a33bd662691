"""Public kernel ops with the reference's signatures (repro.kernels.ops).

The CUDA path computes in float32 like the reference's Pallas path
(repro/kernels/ops.py: rbf_matvec casts its operands to float32); the CPU
path keeps the input dtype like the reference's jnp path. Callers cast the
result back to their query dtype (core.prediction.local.stream_means).
"""
from __future__ import annotations

import torch

from . import rbf_matvec as _rbf_matvec


def rbf_matvec_agents(Xs, Xp, alpha, lengthscales, sigma_f):
    """Every agent's k(Xs, X_m) @ alpha_m in one kernel call -> (M, Nt).

    Xs (Nt, D) queries, Xp (M, Ni, D) agent inputs, alpha (M, Ni) weights.
    Inputs are pre-scaled by 1/lengthscale here, as the reference's op
    does before its kernel."""
    a = Xs / lengthscales
    b = Xp / lengthscales
    sf2 = (sigma_f**2).reshape(1)
    if a.device.type != "cpu":
        a, b, alpha, sf2 = (t.to(torch.float32) for t in (a, b, alpha, sf2))
    return _rbf_matvec.rbf_matvec(a.contiguous(), b.contiguous(),
                                  alpha.contiguous(), sf2.contiguous())


def rbf_matvec(x1, x2, v, lengthscales, sigma_f):
    """Fused k(X1, X2) @ v with O(N + M) memory -> (N,).

    Signature of the reference's `ops.rbf_matvec`: x1 (N, D), x2 (M, D),
    v (M,)."""
    return rbf_matvec_agents(x1, x2[None], v[None], lengthscales,
                             torch.as_tensor(sigma_f, dtype=x1.dtype,
                                             device=x1.device))[0]
