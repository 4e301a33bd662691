"""Streaming multi-agent GP experts: sliding windows with incremental factors.

Counterpart of `repro.core.online.experts`. Each agent keeps a fixed-shape
AGE-ORDERED window (oldest observation in slot 0, newest in slot
count-1, empty slots a contiguous sentinel tail) with its Cholesky factor
L_i and weights alpha_i = C_i^{-1} y_i maintained INCREMENTALLY, O(W^2)
per event against O(W^3) for a refit:

  observe / observe_fleet — if a window is full, evict its oldest first;
      then APPEND at slot `count`: everything below the insert slot is a
      sentinel, so the new sub-diagonal column is exactly zero and the
      insertion is one triangular solve for the new row plus a scalar
      sqrt. alpha follows by two triangular solves.
  evict_oldest — drop slot 0: one rank-1 Cholesky UPDATE of the trailing
      (W-1)^2 block with the evicted point's sub-diagonal column
      (kernels.ops.cholupdate_fleet, the CUDA kernel on the card), the
      one-slot shift fused into the same call.

The agent axis is written out where the reference vmapped: observe_fleet
updates every agent in one call, and an agent whose window is not full is
left out of the rank-1 update by a per-agent mask, read on the device.

Empty slots are *sentinel observations*: pseudo-inputs `_SENTINEL`-far
from the data with y = 0. A sentinel's covariance row/column is exactly
e_p (sigma_f^2 + sigma_eps^2 + jitter), its Cholesky row/column e_p
s_diag and its alpha entry 0 — so `to_fitted()` hands the window arrays
to the batch `PredictionEngine` unchanged. The window covariance masks
its kernel block with the product v v^T (v the valid mask): the kernel's
||a||^2 + ||b||^2 - 2ab expansion leaves garbage in sentinel-sentinel
entries at float32 (sentinel coordinates reach W * 1e6), and the product
with zero removes it. Eviction appends a fresh sentinel at `last
coordinate + _SENTINEL`, keeping sentinels pairwise _SENTINEL-separated.

Every function follows its inputs' device and dtype; the updates return
new tensors and leave the state they were given unchanged. Slot order
fixes the factorization order; `refit` uses the same order, so the
incremental factors are directly comparable to it.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

from ...device import resolve_device
from ...kernels.ops import cholupdate_fleet
from ...obs.tracing import span
from ..gp.kernel import se_kernel, unpack
from ..gp.nll import cho_solve, cholesky
from ..prediction.engine import FittedExperts

_SENTINEL = 1e6


def _sentinel_coords(W: int, D: int, dtype, device) -> torch.Tensor:
    """(W, D) pseudo-inputs, pairwise _SENTINEL-separated and _SENTINEL-far
    from any O(1) data point."""
    return (_SENTINEL * torch.arange(1, W + 1, dtype=dtype, device=device)
            )[:, None].expand(W, D)


def _s_diag(log_theta, jitter):
    """Cholesky diagonal of an empty (sentinel) slot."""
    _, sigma_f, sigma_eps = unpack(log_theta)
    return torch.sqrt(sigma_f**2 + sigma_eps**2 + jitter)


def _fwd_solve(L, b):
    """L sol = b (L lower) for b (..., n)."""
    return torch.linalg.solve_triangular(L, b[..., None], upper=False)[..., 0]


class OnlineExperts(NamedTuple):
    """Per-agent streaming state.

    Age-ordered window: slots [0, count) hold real observations oldest
    first; slots [count, W) are sentinels (see module docstring).
    """
    log_theta: torch.Tensor   # (D+2,)
    Xw: torch.Tensor          # (M, W, D) window inputs; sentinels when invalid
    yw: torch.Tensor          # (M, W)    window targets; 0 when invalid
    L: torch.Tensor           # (M, W, W) chol of the masked window covariance
    alpha: torch.Tensor       # (M, W)    C_i^{-1} y_i; 0 in sentinel slots
    count: torch.Tensor       # (M,) int32 — number of valid observations
    jitter: torch.Tensor      # () factorization jitter (module-wide constant)

    @property
    def num_agents(self) -> int:
        return self.Xw.shape[0]

    @property
    def window(self) -> int:
        return self.Xw.shape[1]

    @property
    def valid(self) -> torch.Tensor:
        """(M, W) bool — which slots hold real observations."""
        return (torch.arange(self.window, device=self.count.device)[None, :]
                < self.count[:, None])

    def to_fitted(self) -> FittedExperts:
        """View as batch `FittedExperts` — serves through PredictionEngine
        unchanged (sentinel slots contribute exactly nothing)."""
        return FittedExperts(self.log_theta, self.Xw, self.yw, self.L,
                             self.alpha)

    @classmethod
    def from_numpy(cls, arrays: Mapping, device=None) -> "OnlineExperts":
        """Carry a streaming fleet across from numpy arrays keyed by field
        name (log_theta, Xw, yw, L, alpha, count, jitter) — e.g. the JAX
        package's OnlineExperts via `np.asarray` — onto `device` (default:
        cuda)."""
        dev = resolve_device(device)
        return cls(*(torch.tensor(arrays[name], device=dev)
                     for name in cls._fields))


def init_online(log_theta, M: int, W: int, D: int, dtype=None,
                jitter: float = 1e-8) -> OnlineExperts:
    """Empty fleet on log_theta's device: every slot a sentinel, factors
    exactly s_diag * I."""
    log_theta = torch.as_tensor(log_theta)
    dtype = log_theta.dtype if dtype is None else dtype
    dev = log_theta.device
    log_theta = log_theta.to(dtype)
    jit = torch.tensor(jitter, dtype=dtype, device=dev)
    Xw = _sentinel_coords(W, D, dtype, dev).expand(M, W, D).clone()
    L = (_s_diag(log_theta, jit) * torch.eye(W, dtype=dtype, device=dev)
         ).expand(M, W, W).clone()
    zeros = torch.zeros((M, W), dtype=dtype, device=dev)
    return OnlineExperts(log_theta, Xw, zeros, L, zeros.clone(),
                         torch.zeros((M,), dtype=torch.int32, device=dev),
                         jit)


def _window_cov(log_theta, jitter, Xw, valid):
    """Masked window covariances (M, W, W): real block K + noise, sentinel
    rows/cols exactly e_p (sigma_f^2 + sigma_eps^2 + jitter) — the matrix
    the incremental updates maintain the factor of."""
    _, sigma_f, sigma_eps = unpack(log_theta)
    v = valid.to(Xw.dtype)
    C = se_kernel(Xw, Xw, log_theta)
    C.mul_(v[..., :, None]).mul_(v[..., None, :])
    diag = C.diagonal(dim1=-2, dim2=-1)
    diag.add_(sigma_eps**2 + jitter)
    diag.add_(sigma_f**2 * (1.0 - v))
    return C


def refit(state: OnlineExperts) -> OnlineExperts:
    """O(W^3) from-scratch refactorization of every window — the reference
    the incremental path is tested and measured against."""
    valid = state.valid
    C = _window_cov(state.log_theta, state.jitter, state.Xw, valid)
    L = cholesky(C).contiguous()
    del C
    alpha = cho_solve(L, state.yw * valid.to(state.yw.dtype))
    return state._replace(L=L, alpha=alpha)


def from_batch(log_theta, Xp, yp, window: int | None = None,
               jitter: float = 1e-8) -> OnlineExperts:
    """Seed a streaming fleet from batch data given OLDEST FIRST (keeps the
    last `window` points per agent when the window is smaller)."""
    Xp, yp = torch.as_tensor(Xp), torch.as_tensor(yp)
    M, Ni, D = Xp.shape
    W = Ni if window is None else int(window)
    if W < Ni:
        Xp, yp = Xp[:, Ni - W:], yp[:, Ni - W:]
        Ni = W
    log_theta = torch.as_tensor(log_theta, device=Xp.device)
    state = init_online(log_theta, M, W, D, dtype=Xp.dtype, jitter=jitter)
    state.Xw[:, :Ni] = Xp
    state.yw[:, :Ni] = yp
    state.count.fill_(Ni)
    return refit(state)


# -- batched incremental cores ----------------------------------------------

def _evict_oldest_shift(log_theta, jitter, Xw, yw, L, active):
    """Drop slot 0 of every `active` agent: the remaining points' factor is
    the rank-1 UPDATE of the trailing block with the evicted sub-diagonal
    column, written one slot up-left in the same call (shift=1); slot W-1
    becomes a fresh sentinel at `last coordinate + _SENTINEL`. Agents not
    active come back unchanged. Returns new (Xw, yw, L)."""
    M, W, _ = Xw.shape
    L = cholupdate_fleet(L, L[:, :, 0], shift=1, active=active)
    evec = _s_diag(log_theta, jitter) * (
        torch.arange(W, device=L.device) == W - 1).to(L.dtype)
    act = active[:, None]
    L[:, W - 1, :] = torch.where(act, evec, L[:, W - 1, :])
    L[:, :, W - 1] = torch.where(act, evec, L[:, :, W - 1])
    Xw = torch.where(active[:, None, None],
                     torch.cat([Xw[:, 1:], Xw[:, W - 1:] + _SENTINEL], 1), Xw)
    yw = torch.where(act, torch.cat([yw[:, 1:], torch.zeros_like(yw[:, :1])],
                                    1), yw)
    return Xw, yw, L


def _append_one(log_theta, jitter, Xw, yw, L, slot, x, y):
    """Write (x[m], y[m]) into sentinel slot `slot[m]` of every agent
    (everything below it is a sentinel, so the new sub-diagonal column is
    exactly zero): one triangular solve for the new row, no trailing sweep.
    Writes into Xw, yw and L in place: the callers' own fresh copies."""
    M, W, _ = Xw.shape
    _, sigma_f, sigma_eps = unpack(log_theta)
    idx = torch.arange(W, device=Xw.device)
    x = x.to(Xw.dtype)
    kvec = se_kernel(Xw, x[:, None, :], log_theta)[..., 0]   # sentinels: 0
    below = idx[None, :] < slot[:, None]
    w = torch.where(below, _fwd_solve(L, torch.where(below, kvec, 0.0)), 0.0)
    d2 = sigma_f**2 + sigma_eps**2 + jitter - (w * w).sum(-1)
    d = torch.sqrt(torch.clamp(d2, min=torch.finfo(Xw.dtype).tiny))
    rows, s = torch.arange(M, device=Xw.device), slot.long()
    L[rows, s] = w + d[:, None] * (idx[None, :] == s[:, None])
    Xw[rows, s] = x
    yw[rows, s] = y.to(yw.dtype)
    return Xw, yw, L


def _evict(log_theta, jitter, Xw, yw, L, active):
    with span("online.evict"):
        return _evict_oldest_shift(log_theta, jitter, Xw, yw, L, active)


def _alpha(L, yw):
    with span("online.alpha"):
        return cho_solve(L, yw)


def _observe_core(log_theta, jitter, Xw, yw, L, count, xs, ys):
    full = count >= Xw.shape[1]
    Xw, yw, L = _evict(log_theta, jitter, Xw, yw, L, full)
    count = torch.where(full, count - 1, count)
    with span("online.append"):
        Xw, yw, L = _append_one(log_theta, jitter, Xw, yw, L, count, xs, ys)
    return Xw, yw, L, _alpha(L, yw), count + 1


def _evict_core(log_theta, jitter, Xw, yw, L, count):
    Xw, yw, L = _evict(log_theta, jitter, Xw, yw, L, count > 0)
    return Xw, yw, L, _alpha(L, yw), torch.clamp(count - 1, min=0)


def _agent_parts(state: OnlineExperts, agent: int):
    return tuple(getattr(state, name)[agent:agent + 1]
                 for name in ("Xw", "yw", "L", "count"))


def _scatter_agent(state: OnlineExperts, agent: int, parts) -> OnlineExperts:
    new = {}
    for name, part in zip(("Xw", "yw", "L", "alpha", "count"), parts):
        t = getattr(state, name).clone()
        t[agent] = part[0]
        new[name] = t
    return state._replace(**new)


# -- public streaming API ----------------------------------------------------

def observe(state: OnlineExperts, agent, x, y) -> OnlineExperts:
    """Agent `agent` ingests one observation, evicting its oldest when the
    window is full. O(W^2)."""
    agent = int(agent)
    Xw, yw, L, count = _agent_parts(state, agent)
    x = torch.as_tensor(x, dtype=Xw.dtype, device=Xw.device)
    y = torch.as_tensor(y, dtype=Xw.dtype, device=Xw.device)
    parts = _observe_core(state.log_theta, state.jitter, Xw, yw, L, count,
                          x.reshape(1, -1), y.reshape(1))
    return _scatter_agent(state, agent, parts)


def observe_fleet(state: OnlineExperts, xs, ys) -> OnlineExperts:
    """Every agent ingests one observation (xs (M, D), ys (M,)) — the
    batched hot path for synchronous streams: one rank-1 update call for
    the agents whose windows are full, then the appends and alpha for
    all."""
    kw = dict(dtype=state.Xw.dtype, device=state.Xw.device)
    xs, ys = torch.as_tensor(xs, **kw), torch.as_tensor(ys, **kw)
    Xw, yw, L, alpha, count = _observe_core(
        state.log_theta, state.jitter, state.Xw, state.yw, state.L,
        state.count, xs, ys)
    return state._replace(Xw=Xw, yw=yw, L=L, alpha=alpha, count=count)


def evict_oldest(state: OnlineExperts, agent) -> OnlineExperts:
    """Drop agent's oldest observation (no-op on an empty window)."""
    agent = int(agent)
    parts = _evict_core(state.log_theta, state.jitter,
                        *_agent_parts(state, agent))
    return _scatter_agent(state, agent, parts)
