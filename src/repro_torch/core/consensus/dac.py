"""Discrete-time average consensus (paper eq. 35, Olfati-Saber 2007).

w_i^{s+1} = w_i^s + eps * sum_{j in N_i} a_ij (w_j^s - w_i^s)

Counterpart of the simulated mode of `repro.core.consensus.dac`: one
matmul with the Perron matrix per sweep. Lemma 1 requires
eps in (0, 1/Delta). `dac` runs a fixed sweep count and returns the
per-sweep maximin residuals like the reference's `lax.scan`; `dac_until`
is the adaptive Python-level wrapper; `dac_time_varying` runs one
adjacency per sweep (paper Assumption 1).

Sharded mode (the reference's shard_map + ppermute collectives): one
tensor per member of an agent mesh (`launch.mesh.AgentMesh`), each on its
member's device, and one tensor per member back. A ring hop moves member
i's tensor to member i+1's device (`.to(..., non_blocking=True)`, in the
reference's ppermute order), so the messages are neighbour-only as on
the reference's device ring. `dac_sharded` is paper eq. 35 on the ring;
`ring_allreduce` (`ring_allsum`, `ring_allmax`) and `ring_allgather` are
the exact finite protocols of n - 1 hops.
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


# ---------------------------------------------------------------------------
# Sharded mode: one tensor per mesh member, ring messages between members
# ---------------------------------------------------------------------------

def _hop(ws, shift: int = 1):
    """One ring permutation: member i's tensor goes to member (i + shift)
    mod n, on that member's device. Returns the received tensors."""
    n = len(ws)
    return [ws[(j - shift) % n].to(ws[j].device, non_blocking=True)
            for j in range(n)]


def dac_sharded(ws, iters: int, eps=None, with_residuals: bool = False):
    """DAC on the cycle graph of the mesh members (paper eq. 35 on the
    ring): each sweep every member exchanges with its two ring
    neighbours. ws: one tensor per member. Returns the members' tensors
    after `iters` sweeps, and with `with_residuals=True` also the per-sweep
    maximin spread across the members (iters,) on member 0's device (the
    reference's opt-in diagnostic, two more collectives a sweep)."""
    n = len(ws)
    if eps is None:
        eps = 1.0 / 3.0          # cycle graph: Delta = 2, eps < 1/Delta
    w = list(ws)
    res = []
    for _ in range(iters):
        left, right = _hop(w, 1), _hop(w, -1)
        nbr = torch._foreach_add(torch._foreach_sub(left, w),
                                 torch._foreach_sub(right, w))
        if n == 2:
            # on a 2-ring both permutations deliver the SAME neighbour;
            # halve so the gain matches the single-edge graph
            torch._foreach_mul_(nbr, 0.5)
        w = torch._foreach_add(w, nbr, alpha=eps)
        if with_residuals:
            res.append(dac_sharded_residual(w)[0])
    if with_residuals:
        traj = torch.stack(res) if res else ws[0].new_zeros(0)
        return w, traj
    return w


def dac_sharded_residual(ws):
    """Maximin consensus spread ACROSS the members, worst entry: the
    members' elementwise maximum minus their minimum (both exact ring
    reductions), replicated on every member."""
    hi = ring_allreduce(ws, torch.maximum)
    lo = ring_allreduce(ws, torch.minimum)
    return [(h - l).amax() for h, l in zip(hi, lo)]


def ring_allreduce(ws, op=torch.add):
    """EXACT all-reduce using only neighbour ring messages: each of the
    n - 1 hops forwards the travelling message one member on and folds it
    into the local accumulator, so every member ends with op(w_0, ...,
    w_{n-1}), folded in ring-arrival order (the members may differ in the
    last ulp for a non-associative op, as in the reference)."""
    acc, msg = list(ws), list(ws)
    for _ in range(len(ws) - 1):
        msg = _hop(msg, 1)
        acc = [op(a, m) for a, m in zip(acc, msg)]
    return acc


def ring_allgather(ws):
    """EXACT all-gather using only neighbour ring messages: member j gets
    (n,) + w.shape with out[i] = member i's tensor, each of the n - 1 hops
    placing the travelling message at its origin slot. Placement, not
    reduction, so every member holds bit-identical copies."""
    n = len(ws)
    out = []
    for j, w in enumerate(ws):
        o = w.new_zeros((n,) + tuple(w.shape))
        o[j] = w
        out.append(o)
    msg = list(ws)
    for hop in range(1, n):
        msg = _hop(msg, 1)
        for j in range(n):
            out[j][(j - hop) % n] = msg[j]
    return out


def ring_allsum(ws):
    """`ring_allreduce` with addition (exact network sums on the ring)."""
    return ring_allreduce(ws, torch.add)


def ring_allmax(ws):
    """`ring_allreduce` with the elementwise maximum (max-flooding)."""
    return ring_allreduce(ws, torch.maximum)
