"""Dataset partitioning across agents (paper §2.3, §6: disjoint stripes).

Counterpart of `repro.core.gp.partition`. Every agent gets N_i = N/M
observations from a spatial stripe (paper Fig. 10-b). Also builds the
grBCM/gapx communication dataset D_c (paper §2.3.2): each agent samples
N_i/M points without replacement, the samples are flooded, and every
agent augments D_{+i} = D_i ∪ D_c (so |D_{+i}| = 2 N_i).
"""
from __future__ import annotations

import warnings

import torch


def stripe_partition(X: torch.Tensor, y: torch.Tensor, M: int,
                     axis: int = 0):
    """Sort by coordinate `axis` and split into M equal stripes.

    Returns (Xp, yp) with shapes (M, N_i, D) and (M, N_i).

    When M does not divide N, the last `N mod M` points in sort order (the
    largest coordinates along `axis`) are absent from every local dataset,
    and a UserWarning says so: equal stripe sizes keep the agent axis
    stackable. Pad or subsample to a multiple of M first if every point
    must be used.
    """
    order = torch.argsort(X[:, axis], stable=True)
    n = (X.shape[0] // M) * M
    dropped = X.shape[0] - n
    if dropped:
        warnings.warn(
            f"stripe_partition: dropping {dropped} trailing point(s) of "
            f"N={X.shape[0]} to make {M} equal stripes of {n // M}",
            UserWarning, stacklevel=2)
    order = order[:n]
    return (X[order].reshape(M, n // M, X.shape[1]),
            y[order].reshape(M, n // M))


def communication_dataset(generator, Xp: torch.Tensor, yp: torch.Tensor):
    """Sample N_i/M points per agent (without replacement) and flood.

    Xp (M, N_i, D), yp (M, N_i) -> (Xc, yc) with N_c = M * floor(N_i/M)
    <= N_i, agent 0's sample first. The draw comes from `generator` (a
    torch.Generator on any device; None takes torch's default one): each
    agent's sample is the first m of a uniform random permutation of its
    points. The reference draws with `jax.random.choice`, whose stream the
    port cannot reproduce, so the two packages agree in distribution only.
    """
    M, Ni, D = Xp.shape
    m = max(Ni // M, 1)
    dev = generator.device if generator is not None else Xp.device
    idx = torch.rand((M, Ni), generator=generator, dtype=torch.float64,
                     device=dev).argsort(dim=1)[:, :m].to(Xp.device)
    Xs = torch.gather(Xp, 1, idx[..., None].expand(M, m, D))
    ys = torch.gather(yp, 1, idx)
    return Xs.reshape(M * m, D), ys.reshape(M * m)


def augment(Xp: torch.Tensor, yp: torch.Tensor, Xc: torch.Tensor,
            yc: torch.Tensor):
    """D_{+i} = D_i ∪ D_c for every agent. Returns (M, N_i + N_c, ...)."""
    M = Xp.shape[0]
    return (torch.cat([Xp, Xc[None].expand(M, *Xc.shape)], dim=1),
            torch.cat([yp, yc[None].expand(M, *yc.shape)], dim=1))
