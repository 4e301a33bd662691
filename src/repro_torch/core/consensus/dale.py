"""Distributed algorithm for linear equations (DALE, paper eq. 38;
Wang/Mou/Liu).

q_i^{s+1} = H_i^T (H_i H_i^T)^-1 b_i + (1/|N_i|) P_i sum_{j in N_i} q_j^s
P_i = I - H_i^T (H_i H_i^T)^-1 H_i   (projection onto ker H_i)

Counterpart of the simulated mode of `repro.core.consensus.dale`. Unlike
JOR, each agent keeps the FULL solution vector q_i in R^M and exchanges
only with neighbours: strongly connected suffices (Assumption 1), which
is what lets DEC-NN-NPAE drop the strongly-complete requirement. Needs H
full row rank (Assumption 10), guaranteed after CBNN (Lemma 6).

Batched over leading dimensions of H (one system per query) and over
stacked right-hand sides: per iteration one product with the averaging
matrix A / max(deg, 1) over the agent axis and one batched product with
the agents' projections P_i, for every system and column at once.
"""
from __future__ import annotations

import torch

from .jor import _iterate


def dale(H, b, A, iters: int):
    """Simulated-network DALE. H (..., M, M), b (..., M) or (..., M, K)
    (K stacked right-hand sides), adjacency A (M, M).

    Returns (Q (..., M, M) or (..., M, M, K): every agent's copy of the
    solution along axis -2 (-3 with K), residuals (..., iters))."""
    vec = b.dim() == H.dim() - 1
    M = H.shape[-1]
    batch = H.shape[:-2]
    bm = b[..., None] if vec else b                         # (..., M, K)
    K = bm.shape[-1]
    hnorm = (H * H).sum(-1)                                 # H_i H_i^T
    g = H / hnorm[..., None]                                # H_i^T / |H_i|^2
    x_part = g[..., None] * bm[..., None, :]                # (..., M, M, K)
    eye = torch.eye(M, dtype=H.dtype, device=H.device)
    P = eye - g[..., :, None] * H[..., None, :]             # (..., M, M, M)
    Af = torch.as_tensor(A).to(device=H.device, dtype=H.dtype)
    # a degree-0 agent (single-agent graph, severed node) has an all-zero
    # neighbour sum; dividing by max(deg, 1) keeps it at its local solution
    # x_part instead of 0/0 = NaN, and is exact for deg >= 1
    W = Af / torch.clamp(Af.sum(1), min=1.0)[:, None]
    Bn = x_part.reshape(-1, M, M * K).shape[0]
    Wb = W.expand(Bn, M, M).contiguous()
    P3 = P.reshape(Bn * M, M, M)
    x3 = x_part.reshape(Bn * M, M, K)
    U = x_part.new_empty((Bn, M, M * K))

    def step(Q, out):
        torch.bmm(Wb, Q, out=U)                             # neighbour avg
        torch.baddbmm(x3, P3, U.view(Bn * M, M, K),
                      out=out.view(Bn * M, M, K))

    Q, res = _iterate(step, x_part.reshape(Bn, M, M * K), iters)
    Q = Q.reshape(*batch, M, M, K)
    return (Q[..., 0] if vec else Q), res.T.reshape(*batch, iters)


def dale_sharded(h_rows, bs, iters: int):
    """Sharded DALE on the cycle graph of the mesh members: member i holds
    (row_i H, b_i), keeps a full-length q_i and exchanges it with its two
    ring neighbours each iteration. Returns the members' q_i (M,)."""
    from .dac import _hop
    hnorm = [h @ h for h in h_rows]
    x_part = [h * b / hn for h, b, hn in zip(h_rows, bs, hnorm)]
    q = list(x_part)
    for _ in range(iters):
        left, right = _hop(q, 1), _hop(q, -1)
        q = []
        for h, hn, xp, lf, rt in zip(h_rows, hnorm, x_part, left, right):
            avg = (lf + rt) / 2.0
            q.append(xp + (avg - h * (h @ avg) / hn))
    return q
