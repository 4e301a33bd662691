"""Degraded-mode consensus: masked reductions over the live subgraph.

Counterpart of `repro.core.consensus.degraded` (simulated mode). The
paper's protocols assume every agent answers every round (eq. 35 iterates
a FIXED Perron matrix). Under churn a dead agent's stale state would keep
being averaged in, and a partitioned graph would silently converge per
component; this module makes both explicit:

  masked_perrons    the per-round update matrices of a fault schedule,
                    W_t = I + eps (A_t - diag d_t) with A_t = A * alive_t
                    alive_t^T (* edge_t): the Perron update rebuilt from
                    the LIVE subgraph's degrees (eps < 1/Delta_t holds on
                    every subgraph). A dead agent's row is e_i, so with
                    finite payloads it keeps its state exactly (it neither
                    sends nor receives). Built once per schedule, in one
                    batched op; the serving engine caches them per plan.
  dac_masked        DAC over a per-round live mask (and optional per-round
                    edge-survival masks): one product with W_t a sweep.
  dac_masked_sums   the degraded counterpart of the engine's `_dac_sums`
                    readout: network sums estimated from the READOUT
                    component only. With dead-from-round-0 agents the
                    estimate is exact masked aggregation; with mid-run
                    dropout an honest estimate over the survivors (flagged
                    degraded by the caller, guarded by the residual).
  ring_allsum_masked the exact-ring counterpart for the sharded mode's
                    collectives: dead members contribute zero instead of
                    stale values.

Convergence failures surface as `ConsensusDiverged` from the serving
layer, never as silent NaN or stale results. Partition detection is
host-side (`graph.connected_components` on the final live subgraph).
"""
from __future__ import annotations

import torch

from .graph import max_degree


class ConsensusDiverged(RuntimeError):
    """A consensus run failed to converge (residual above tolerance) or
    produced non-finite moments; raised instead of returning them."""


def _masked_maximin(w: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Maximin spread over the LIVE rows only: dead agents hold frozen
    state that never re-converges and must not dominate the criterion.
    w (..., M, K), alive (..., M) 0/1 -> (...,). With no live row the
    spread is -inf, as in the reference."""
    a = alive.to(torch.bool)[..., None]
    hi = torch.where(a, w, -torch.inf).amax(-2)
    lo = torch.where(a, w, torch.inf).amin(-2)
    return (hi - lo).amax(-1)


def masked_perrons(A, alive_seq, eps=None, edge_seq=None) -> torch.Tensor:
    """The per-round update matrices (iters, M, M) of a fault schedule,
    in float64 on alive_seq's device: W_t = I + eps (A_t - diag d_t),
    A_t = A * alive_t alive_t^T (* edge_t), d_t the live degrees. eps
    defaults to 1/(Delta_full + 1), valid on every subgraph since
    Delta_t <= Delta_full."""
    alive = torch.as_tensor(alive_seq).to(torch.float64)
    A = torch.as_tensor(A).to(alive.device, torch.float64)
    if eps is None:
        eps = 1.0 / (float(max_degree(A)) + 1.0)
    A_t = A * alive[:, :, None] * alive[:, None, :]
    if edge_seq is not None:
        A_t = A_t * torch.as_tensor(edge_seq).to(alive.device, torch.float64)
    eye = torch.eye(A.shape[0], dtype=torch.float64, device=alive.device)
    return eye + eps * (A_t - torch.diag_embed(A_t.sum(-1)))


def _sweep(w0: torch.Tensor, W_seq: torch.Tensor, alive_seq):
    """Sweep w0 (M,) or (M, K) through the update matrices W_seq
    (iters, M, M): one product a sweep, each written into a preallocated
    trajectory, the masked residuals reduced once after the loop. Returns
    (w_final, live-row maximin residual trajectory (iters,))."""
    W = W_seq.to(device=w0.device, dtype=w0.dtype)
    iters = W.shape[0]
    w2 = w0.reshape(w0.shape[0], -1)
    traj = torch.empty((iters,) + w2.shape, dtype=w0.dtype, device=w0.device)
    w = w2
    for t in range(iters):
        w = torch.matmul(W[t], w, out=traj[t])
    alive = torch.as_tensor(alive_seq).to(w0.device)
    res = _masked_maximin(traj, alive) if iters else w0.new_zeros(0)
    return w.reshape(w0.shape), res


def dac_masked(w0: torch.Tensor, A, alive_seq, eps=None, edge_seq=None):
    """DAC sweeps over a time-varying live subgraph.

    w0 (M,) or (M, K); A (M, M) the full-fleet adjacency; alive_seq
    (iters, M) per-round live masks (0/1); edge_seq (iters, M, M) optional
    per-round edge-survival masks (message loss). Returns (w_final, masked
    maximin residual trajectory (iters,)). A rejoining agent resumes from
    the value it held at dropout (the stale-rejoin the residual guard
    exists to catch)."""
    W = masked_perrons(A, torch.as_tensor(alive_seq).to(w0.device), eps,
                       edge_seq)
    return _sweep(w0, W, alive_seq)


def perron_sums(w0: torch.Tensor, W_seq: torch.Tensor, alive_seq, readout,
                n_relay):
    """`dac_masked_sums` through precomputed update matrices W_seq (the
    serving engine caches them per fault plan)."""
    w, res = _sweep(w0, W_seq, alive_seq)
    r = torch.as_tensor(readout).to(w0.device, w0.dtype)
    comp_mean = (r @ w) / torch.clamp(r.sum(), min=1.0)
    # the last residual is remeasured over the READOUT members only: other
    # components legitimately settle elsewhere and must not trip the guard
    res = res.clone()
    res[-1] = _masked_maximin(w, r)
    n = torch.as_tensor(n_relay).to(w0.device, w0.dtype)
    return n * comp_mean, res


def dac_masked_sums(w0: torch.Tensor, A, alive_seq, readout, n_relay,
                    edge_seq=None, eps=None):
    """Degraded network-sums readout (the engine's `_dac_sums` under a
    fault plan).

    w0 (M, K) payload rows; readout (M,) 0/1 marks the surviving
    component members the answer is read from; n_relay the count of agents
    whose payload ever entered that component's relay (with dead-from-
    round-0 agents exactly the live member count, and the estimate is
    exact masked aggregation). Returns (sums (K,), residuals (iters,)).

    At the no-fault limit this is M * mean(w), but not bit for bit (the
    per-round matrices are rebuilt where the exact path uses one Perron),
    which is why callers send consensus-free plans to `_dac_sums`."""
    W = masked_perrons(A, torch.as_tensor(alive_seq).to(w0.device), eps,
                       edge_seq)
    return perron_sums(w0, W, alive_seq, readout, n_relay)


def ring_allsum_masked(ws, alive):
    """Exact ring sum where dead members contribute zero. `alive` holds
    each member's 0/1 liveness flag. Dead members still forward ring
    messages (the ring stays intact) but their own payload is zeroed
    before it enters the lap. Returns the sum of the live contributions on
    every member."""
    from .dac import ring_allsum
    return ring_allsum([w * torch.as_tensor(a, dtype=w.dtype,
                                            device=w.device)
                        for w, a in zip(ws, alive)])
