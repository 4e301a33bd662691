"""Algebraic graph theory foundations (paper §2.1).

Counterpart of `repro.core.consensus.graph`. Graphs are dense float64
adjacency matrices A (M, M) on the CPU — fleets of a few hundred agents at
most — and consumers move them to their own device and dtype.
"""
from __future__ import annotations

import numpy as np
import torch


def _path(M: int) -> np.ndarray:
    A = np.zeros((M, M))
    for i in range(M - 1):
        A[i, i + 1] = A[i + 1, i] = 1.0
    return A


def path_graph(M: int) -> torch.Tensor:
    return torch.from_numpy(_path(M))


def cycle_graph(M: int) -> torch.Tensor:
    A = _path(M)
    if M > 2:
        A[0, M - 1] = A[M - 1, 0] = 1.0
    return torch.from_numpy(A)


def complete_graph(M: int) -> torch.Tensor:
    return torch.from_numpy(np.ones((M, M)) - np.eye(M))


def random_connected_graph(M: int, p: float, seed: int = 0) -> torch.Tensor:
    """Erdos-Renyi edges overlaid on a path (guarantees connectivity).

    Draws with numpy's `default_rng(seed)` exactly as the reference does,
    so both packages build the same graph from the same seed."""
    rng = np.random.default_rng(seed)
    A = _path(M)
    extra = np.triu(rng.random((M, M)) < p, 1)
    return torch.from_numpy(np.maximum(A, extra + extra.T))


def attach_agent(A, neighbors) -> torch.Tensor:
    """Grow A by one node wired (bidirectionally) to `neighbors`.

    The joiner must attach to at least one existing agent or the fleet
    would split into components and consensus would silently average
    per component.
    """
    An = np.asarray(torch.as_tensor(A).cpu())
    M = An.shape[0]
    neighbors = [int(n) for n in np.atleast_1d(np.asarray(neighbors))]
    if M and not neighbors:
        raise ValueError("joining agent needs at least one neighbor")
    if any(not 0 <= n < M for n in neighbors):
        raise ValueError(f"neighbors {neighbors} out of range for M={M}")
    A2 = np.zeros((M + 1, M + 1), An.dtype)
    A2[:M, :M] = An
    for n in neighbors:
        A2[M, n] = A2[n, M] = 1.0
    return torch.from_numpy(A2)


def remove_agent(A, i: int, reconnect: bool = True) -> torch.Tensor:
    """Delete node i from A. With `reconnect`, the removed node's former
    neighbors are chained in index order, so removing a cut vertex (e.g.
    an interior path node) cannot disconnect the graph."""
    An = np.asarray(torch.as_tensor(A).cpu())
    i = int(i)
    nbrs = np.flatnonzero(An[i] > 0)
    A2 = np.delete(np.delete(An, i, axis=0), i, axis=1)
    if reconnect and len(nbrs) > 1:
        shifted = [int(n) - (n > i) for n in nbrs]
        for a, b in zip(shifted[:-1], shifted[1:]):
            A2[a, b] = A2[b, a] = 1.0
    return torch.from_numpy(A2)


def degree_matrix(A: torch.Tensor) -> torch.Tensor:
    return torch.diag(A.sum(dim=1))


def laplacian(A: torch.Tensor) -> torch.Tensor:
    return degree_matrix(A) - A


def max_degree(A: torch.Tensor) -> torch.Tensor:
    """Delta = max_i sum_{j != i} a_ij."""
    return A.sum(dim=1).max()


def perron(A: torch.Tensor, eps) -> torch.Tensor:
    """P = I - eps * L (paper §2.1)."""
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return eye - eps * laplacian(A)


def _all_pairs_dist(A, alive=None) -> np.ndarray:
    """Shortest-path hop counts (M, M) by Floyd-Warshall on the dense
    graph (inf between components), restricted to the live subgraph when
    `alive` (M,) is given."""
    An = np.asarray(torch.as_tensor(A).cpu()) > 0
    M = An.shape[0]
    if alive is not None:
        live = np.asarray(alive).astype(bool)
        An = An & live[:, None] & live[None, :]
    dist = np.full((M, M), np.inf)
    np.fill_diagonal(dist, 0)
    dist[An] = 1
    for k in range(M):
        dist = np.minimum(dist, dist[:, k:k + 1] + dist[k:k + 1, :])
    return dist


def _reach(A, alive=None) -> np.ndarray:
    """Boolean reachability (M, M)."""
    return np.isfinite(_all_pairs_dist(A, alive))


def diameter(A) -> float:
    """Max shortest-path distance diam(G); inf if disconnected."""
    return float(_all_pairs_dist(A).max())


def is_connected(A) -> bool:
    return bool(_reach(A).all())


def connected_components(A, alive=None) -> np.ndarray:
    """Component labels (M,) int: nodes i, j share a label iff connected.

    Labels are the smallest member index of each component. `alive` (M,)
    restricts the graph to the live subgraph first: dead nodes lose every
    incident edge and come out as singleton components."""
    reach = _reach(A, alive)
    return np.array([int(np.flatnonzero(row)[0]) for row in reach])
