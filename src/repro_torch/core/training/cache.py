"""Cached-geometry training hot path, counterpart of
`repro.core.training.cache`.

Every ADMM iteration of the paper's training methods (§3-§4) needs, per
agent, the local NLL gradient at the current theta. The geometry of each
agent's X is pure data — only theta changes across iterations — so the
work splits:

  TrainingCache    — once per fit: the per-agent per-dimension UNSCALED
                     diff^2 stacks d2u[d] = (x_d - x'_d)^2.
  nll_grad_cached  — per iteration: scale + exp rebuild C, one Cholesky,
                     inner = C^-1 - alpha alpha^T, then the one-pass fused
                     contraction `kernels.ops.nll_grad_fused_agents` (the
                     hand-written nll_grad kernel on the card, its plain
                     version on the CPU) for all D+2 components of every
                     agent at once.
  make_local_grad  — resolves the `grad_fn` hook shared by every ADMM
                     training loop.

Every function takes a leading agent axis (M, ...) where the reference
vmapped, or none for one agent.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from ...kernels.ops import nll_grad_fused, nll_grad_fused_agents
from ...obs.tracing import span
from ..gp.kernel import diff2_stack, unpack
from ..gp.nll import (effective_jitter, inner_from_cov, nll, nll_from_cov,
                      value_and_grad)


class TrainingCache(NamedTuple):
    """Per-agent training-time geometry, computed once per fit."""
    d2u: torch.Tensor   # (..., D, N, N) unscaled per-dimension diff^2
    y: torch.Tensor     # (..., N)       local targets


def build_training_cache(Xp: torch.Tensor, yp: torch.Tensor) -> TrainingCache:
    """Precompute the iteration-invariant geometry. Xp (M, N, D) or (N, D).

    Memory: O(D N^2) per agent, held once across the whole ADMM run."""
    return TrainingCache(diff2_stack(Xp), yp)


def cov_from_cache(log_theta, d2u, jitter: float = 1e-8):
    """(C, K) from the cached geometry: one contraction over d2u, one exp
    and the diagonal."""
    ls, sigma_f, sigma_eps = unpack(log_theta)
    d2s = torch.einsum("...d,...dij->...ij", 1.0 / ls**2, d2u)
    K = sigma_f[..., None, None]**2 * torch.exp(-d2s)
    jit_eff = effective_jitter(log_theta, d2u.dtype, jitter)
    C = K.clone()
    C.diagonal(dim1=-2, dim2=-1).add_((sigma_eps**2 + jit_eff)[..., None])
    return C, K


def nll_from_cache(log_theta, d2u, y, jitter: float = 1e-8):
    """NLL value from cached geometry — matches gp.nll on the same data."""
    C, _ = cov_from_cache(log_theta, d2u, jitter)
    return nll_from_cov(C, y)


def nll_grad_cached(log_theta, d2u, y, jitter: float = 1e-8):
    """dNLL/dlog_theta (..., D+2) via the cached-geometry fused path: one
    Cholesky and its inverse per agent, then the single fused contraction
    for the whole fleet (one kernel launch on the card)."""
    with span("train.factor"):
        C, K = cov_from_cache(log_theta, d2u, jitter)
    inner = inner_from_cov(C, y)
    fused = nll_grad_fused if d2u.dim() == 3 else nll_grad_fused_agents
    return fused(log_theta, d2u, inner, K=K)


def local_nll(log_theta, aux, jitter: float = 1e-8):
    """Per-agent NLL value from whatever aux `make_local_grad`'s prepare
    built — TrainingCache (fused path) or the raw (X, y) tuple (autodiff
    and custom hooks). The `diag=True` mode of the ADMM loops records it
    every iteration."""
    if isinstance(aux, TrainingCache):
        return nll_from_cache(log_theta, aux.d2u, aux.y, jitter=jitter)
    return nll(log_theta, *aux, jitter=jitter)


def _free_mb(device) -> float:
    """Free memory of the card that holds `device`, in MB."""
    return torch.cuda.mem_get_info(device)[0] / 2**20


def _per_agent(g):
    """Lift a per-agent gradient (log_theta (K,), Xi, yi) -> (K,) to the
    fleet: one call per agent row, as the reference vmaps it."""
    def grad(log_theta, X, y):
        if log_theta.dim() == 1:
            return g(log_theta, X, y)
        return torch.stack([g(log_theta[i], X[i], y[i])
                            for i in range(log_theta.shape[0])])
    return grad


def make_local_grad(grad_fn=None, jitter: float = 1e-8,
                    cache_limit_mb: float = 4096.0):
    """Resolve the `grad_fn` hook of the ADMM training loops.

    grad_fn:
      None            — cached-geometry fused path (the default hot path):
                        `prepare` builds a TrainingCache once per fit,
                        guarded by `cache_limit_mb` (the cache is
                        O(M D N^2)). On the CPU fleets past the limit
                        fall back to the autodiff hook with a
                        UserWarning, the reference's memory policy. On
                        the card the limit is at least half the card's
                        free memory, and a cache past it raises
                        MemoryError: card tensors take the nll_grad
                        kernel or nothing.
      "fused"         — cached-geometry path, unguarded.
      "autodiff"      — autograd of `nll` on raw (X, y).
      callable        — custom per-agent gradient (log_theta, Xi, yi) ->
                        (D+2,), called once per agent.

    Returns (prepare, grad): `prepare(Xp, yp)` -> aux whose tensors share
    Xp's leading agent axis; `grad(log_theta, aux)` -> the local NLL
    gradients, (M, D+2) for thetas (M, D+2) and a fleet's aux (or (D+2,)
    for one agent). Where the reference vmaps over agents, the fused path
    takes the whole fleet at once.
    """
    def autodiff(log_theta, X, y):
        return value_and_grad(nll, log_theta, X, y, jitter=jitter)[1]

    if grad_fn in (None, "fused"):
        guarded = grad_fn is None

        def prepare(Xp, yp):
            if guarded:
                n, D = Xp.shape[-2], Xp.shape[-1]
                m = Xp.shape[0] if Xp.dim() == 3 else 1
                est_mb = m * D * n * n * Xp.element_size() / 2**20
                on_card = Xp.device.type != "cpu"
                limit = max(cache_limit_mb, _free_mb(Xp.device) / 2) \
                    if on_card else cache_limit_mb
                if est_mb > limit and on_card:
                    raise MemoryError(
                        f"cached-geometry training would hold {est_mb:.0f} "
                        f"MB of diff^2 stacks (M={m}, N={n}, D={D}) > "
                        f"{limit:.0f} MB (half the card's free memory); "
                        f"the card trains through the nll_grad kernel "
                        f"only — shrink the windows or the fleet")
                if est_mb > limit:
                    warnings.warn(
                        f"cached-geometry training would hold {est_mb:.0f} "
                        f"MB of diff^2 stacks (M={m}, N={n}, D={D}) > "
                        f"{cache_limit_mb:.0f} MB; falling back to autodiff "
                        f"gradients — pass grad_fn='fused' to force the "
                        f"cache", stacklevel=2)
                    return (Xp, yp)
            return build_training_cache(Xp, yp)

        def grad(log_theta, aux):
            if isinstance(aux, TrainingCache):
                return nll_grad_cached(log_theta, aux.d2u, aux.y,
                                       jitter=jitter)
            return autodiff(log_theta, *aux)
        return prepare, grad

    # the autodiff baseline takes the SAME jitter: both hooks optimize the
    # same objective for any jitter
    g = autodiff if grad_fn == "autodiff" else _per_agent(grad_fn)

    def prepare(Xp, yp):
        return (Xp, yp)

    def grad(log_theta, aux):
        return g(log_theta, *aux)
    return prepare, grad
