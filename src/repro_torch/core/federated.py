"""Loss-agnostic decentralized consensus strategies on the agent mesh
(counterpart of repro.core.federated).

The closed-form proximal update of the paper's Theorem 1 (DEC-apx-GP,
eq. 34) needs only the local gradient at the current iterate, so it
applies verbatim to any differentiable local loss, the LM's included.
Each member of an agent mesh (`launch.mesh.AgentMesh`) is an agent with a
private data shard and its own parameter opinion: a dict name -> tensor
on the member's device. Every function here takes and returns one such
dict per member, in mesh order; a ring hop moves a member's tensor to the
next member's device (`core.consensus.dac._hop`), so only ring neighbours
exchange messages, as the reference's ppermute does on its device ring.

Strategies (`ConsensusConfig.strategy`):
  allreduce : centralized baseline, the mean of the members' gradients
              (an exact ring all-reduce, divided by M).
  dec_admm  : DEC-apx-GP on parameter dicts. Member i keeps theta_i and a
              dual p_i; one round is
                p_i    += rho * sum_{j in N_i} (theta_i - theta_j)
                theta_i = (rho sum_j theta_j - g_i + (kappa + |N| rho)
                           theta_i - p_i) / (kappa + 2 |N| rho)
              with the ring neighbours; no gradient or data crosses the
              network (paper Assumption 2).
  dac       : gossip sweeps of discrete-time average consensus (eq. 35)
              applied to gradients, an inexact averaging baseline.

The ring is the cycle graph of the M members, of degree min(M - 1, 2): a
two-member ring sees its single neighbour once, and one member sees none
(its neighbour sum is zeros), as the reference's `_neighbor_sum`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .consensus.dac import _hop, ring_allreduce


@dataclass(frozen=True)
class ConsensusConfig:
    strategy: str = "allreduce"        # allreduce | dec_admm | dac
    rho: float = 1.0                   # ADMM penalty
    kappa: float = 10.0                # proximal penalty (Theorem 1 condition)
    dac_eps: float = 1.0 / 3.0         # Perron parameter (cycle graph, Delta=2)
    dac_sweeps: int = 1


def neighbor_sum(ws):
    """(the sum of each member's ring neighbours' tensors, the ring's
    degree) for one tensor per member: the forward hop's message plus,
    for M > 2, the backward hop's; zeros and degree 0 for one member."""
    M = len(ws)
    if M == 1:
        return [torch.zeros_like(ws[0])], 0.0
    left = _hop(ws, 1)
    if M == 2:
        return left, 1.0
    return [a + b for a, b in zip(left, _hop(ws, -1))], 2.0


def _leafwise(fn, trees):
    """Apply fn(list of the members' tensors) -> list, key by key, over
    one dict per member; returns one dict per member."""
    out = [dict() for _ in trees]
    for key in trees[0]:
        for o, t in zip(out, fn([tree[key] for tree in trees])):
            o[key] = t
    return out


def allreduce_grads(grads):
    """Baseline: every member gets the mean of the members' gradients."""
    M = len(grads)
    return _leafwise(lambda gs: [s / M for s in ring_allreduce(gs)], grads)


def dac_grads(grads, cfg: ConsensusConfig):
    """Gossip-average gradients: `cfg.dac_sweeps` Perron steps on the
    ring, g_i + eps (sum_{j in N_i} g_j - |N| g_i)."""
    def sweeps(gs):
        for _ in range(cfg.dac_sweeps):
            nbr, deg = neighbor_sum(gs)
            gs = [g + cfg.dac_eps * (s - deg * g) for g, s in zip(gs, nbr)]
        return gs
    return _leafwise(sweeps, grads)


def dec_admm_init(params):
    """Dual state p_i, zeros shaped like each member's parameters."""
    return [{k: torch.zeros_like(v) for k, v in p.items()} for p in params]


def dec_admm_leaf(th, p, g, s, deg: float, rho: float, kappa: float):
    """One member's round of eq. 34a-b on one tensor: its opinion th,
    dual p, local gradient g and neighbours' sum s over `deg` neighbours.
    Returns (theta_next in th's dtype, p_next in p's dtype)."""
    p_next = p + rho * (deg * th - s)                              # (34a)
    th_next = (rho * s - g + (kappa + deg * rho) * th - p_next) \
        / (kappa + 2.0 * deg * rho)                                # (34b)
    return th_next.to(th.dtype), p_next.to(p.dtype)


def dec_admm_update(params, duals, grads, cfg: ConsensusConfig):
    """One generalized DEC-apx-GP round (eq. 34a-b) on every member's
    parameter dict. Returns (new_params, new_duals), one dict per member;
    `grads` are the members' LOCAL gradients, never communicated."""
    new_params = [dict() for _ in params]
    new_duals = [dict() for _ in params]
    for key in params[0]:
        ths = [p[key] for p in params]
        nbr, deg = neighbor_sum(ths)
        for i, (th, s) in enumerate(zip(ths, nbr)):
            new_params[i][key], new_duals[i][key] = dec_admm_leaf(
                th, duals[i][key], grads[i][key], s, deg, cfg.rho,
                cfg.kappa)
    return new_params, new_duals


def consensus_disagreement(params):
    """Per member, max |theta_i - mean_j theta_j| over every entry of its
    parameters: the convergence metric, the mean from an exact ring
    all-reduce. Returns one 0-d tensor per member, on its device."""
    M = len(params)
    worst = [None] * M
    for key in params[0]:
        xs = [p[key] for p in params]
        for i, (x, s) in enumerate(zip(xs, ring_allreduce(xs))):
            d = (x - s / M).abs().max()
            worst[i] = d if worst[i] is None else torch.maximum(worst[i], d)
    return worst
