"""Dataset partitioning across agents (paper §2.3, §6: disjoint stripes).

Counterpart of `repro.core.gp.partition.stripe_partition`.
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
