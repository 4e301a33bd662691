"""Discrete-time average consensus (paper eq. 35, Olfati-Saber 2007).

w_i^{s+1} = w_i^s + eps * sum_{j in N_i} a_ij (w_j^s - w_i^s)

Counterpart of the simulated mode of `repro.core.consensus.dac`: one
matmul with the Perron matrix per sweep. Lemma 1 requires
eps in (0, 1/Delta). `dac` runs a fixed sweep count and returns the
per-sweep maximin residuals like the reference's `lax.scan`; `dac_until`
is the adaptive Python-level wrapper; `dac_time_varying` runs one
adjacency per sweep (paper Assumption 1).
"""
from __future__ import annotations

import torch

from .graph import max_degree, perron


def _maximin_residual(w: torch.Tensor) -> torch.Tensor:
    """Worst per-column maximin spread (Yadav & Salapaka) over the agent
    axis 0 of w (..., M, K): each column is an independent consensus."""
    spread = w.amax(dim=-2) - w.amin(dim=-2)
    return spread.reshape(*spread.shape[:-1], -1).amax(dim=-1)


def dac(w0: torch.Tensor, A: torch.Tensor, iters: int, eps=None):
    """Run `iters` DAC sweeps. w0 (M,) or (M, K) — K parallel consensuses.

    Returns (w_final, residual trajectory (iters,)). The Perron matrix is
    built in float64 and cast to w0's dtype, as the reference does.
    """
    A = A.to(device=w0.device, dtype=torch.float64)
    if eps is None:
        eps = 1.0 / (max_degree(A) + 1.0)
    P = perron(A, eps).to(w0.dtype)
    w2 = w0.reshape(w0.shape[0], -1)
    # every sweep writes into one preallocated trajectory; the residuals
    # are reduced once after the loop
    traj = torch.empty((iters,) + w2.shape, dtype=w0.dtype, device=w0.device)
    w = w2
    for s in range(iters):
        w = torch.matmul(P, w, out=traj[s])
    res = _maximin_residual(traj) if iters else w0.new_zeros(0)
    return w.reshape(w0.shape), res


def dac_residual(w: torch.Tensor) -> torch.Tensor:
    """Maximin spread: the network has reached consensus when this is ~0."""
    return _maximin_residual(w.reshape(w.shape[0], -1))


def dac_until(w0, A, tol: float = 1e-9, max_iters: int = 100_000,
              eps=None, chunk: int = 64):
    """Adaptive DAC: run `chunk` sweeps at a time until the maximin
    criterion fires. Returns (w, total_iters)."""
    w, iters = w0, 0
    while iters < max_iters:
        w, res = dac(w, A, chunk, eps=eps)
        iters += chunk
        if float(res[-1]) < tol:
            break
    return w, iters


def dac_time_varying(w0: torch.Tensor, A_seq: torch.Tensor, eps: float):
    """DAC over a TIME-VARYING graph (paper Assumption 1): A_seq (T, M, M)
    gives the adjacency at each sweep; convergence requires the union over
    every gamma-window to be strongly connected.

    Returns (w_final, residual trajectory (T,)). Each sweep's Perron matrix
    is I - eps * Laplacian(A_t) in w0's dtype, as in the reference."""
    A_seq = torch.as_tensor(A_seq).to(w0.device)
    M = A_seq.shape[-1]
    eye = torch.eye(M, dtype=w0.dtype, device=w0.device)
    w, res = w0, []
    for A_t in A_seq:
        lap = torch.diag(A_t.sum(1)) - A_t
        w = (eye - eps * lap.to(w0.dtype)) @ w
        res.append(_maximin_residual(w.reshape(M, -1)))
    traj = torch.stack(res) if res else w0.new_zeros(0)
    return w, traj
