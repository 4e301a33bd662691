"""Inputs of every cell, made on the device from `--seed` in a few large
calls: the paper's §6 synthetic field (one random-Fourier-feature draw of
the SE GP prior with the configuration's true hyperparameters), its noisy
training points striped over the agents by the first coordinate, query
rows and streamed observations. The program and the reference are handed
the same tensors.

The field is the benchmark's own copy of the RFF construction: spectral
frequencies N(0, 2 / l^2) per dimension, phases U(0, 2 pi), weights N(0, 1),
f(x) = sigma_f sqrt(2 / F) cos(x W^T + b) w.
"""
from __future__ import annotations

import math

import torch

SEED_MASK = (1 << 63) - 1


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on `device` for stream `stream` of run seed `seed` (any
    non-negative whole number; large ones are folded into 63 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) & SEED_MASK)
    return g


class Field:
    """One draw f ~ GP(0, sf^2 exp(-sum d^2 / l^2)), callable on (N, D)."""

    def __init__(self, gen, theta, D: int, features: int, dtype, device):
        ls = torch.tensor(theta[:D], dtype=dtype, device=device)
        kw = dict(generator=gen, dtype=dtype, device=device)
        self.sf = float(theta[D])
        self.W = torch.randn(features, D, **kw) * (math.sqrt(2.0) / ls)
        self.b = 2 * math.pi * torch.rand(features, **kw)
        self.w = torch.randn(features, **kw)
        self.scale = math.sqrt(2.0 / features)

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        phi = torch.cos(X @ self.W.T + self.b)
        return self.sf * self.scale * (phi @ self.w)


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg["dtype"])


def fleet_data(cfg: dict, seed: int, device):
    """The configuration's fleet: (Xp (M, Ni, D), yp (M, Ni), field,
    gen) with n_train points uniform on the domain, y = f + sigma_eps
    noise, sorted by the first coordinate and cut into M equal stripes
    (oldest first in each stripe is the sort order)."""
    dt = _dtype(cfg)
    D, M, n = cfg["input_dim"], cfg["num_agents"], cfg["n_train"]
    lo, hi = cfg["domain"]
    gen = generator(seed, device)
    field = Field(gen, cfg["true_theta"], D, cfg["rff_features"], dt,
                  device)
    X = lo + (hi - lo) * torch.rand(n, D, generator=gen, dtype=dt,
                                    device=device)
    y = field(X) + cfg["true_theta"][-1] * torch.randn(
        n, generator=gen, dtype=dt, device=device)
    order = torch.argsort(X[:, 0], stable=True)
    Ni = n // M
    order = order[:M * Ni]
    return (X[order].reshape(M, Ni, D).contiguous(),
            y[order].reshape(M, Ni).contiguous(), field, gen)


def queries(cfg: dict, gen, n: int, device) -> torch.Tensor:
    """n query rows uniform on the domain."""
    lo, hi = cfg["domain"]
    return lo + (hi - lo) * torch.rand(n, cfg["input_dim"], generator=gen,
                                       dtype=_dtype(cfg), device=device)


def stream_observations(cfg: dict, field, gen, Xp, rounds: int):
    """One new observation per agent a round, uniform in the agent's stripe
    of the first coordinate and over the domain in the others:
    (xs (rounds, M, D), ys (rounds, M))."""
    lo, hi = cfg["domain"]
    M, _, D = Xp.shape
    a, b = Xp[..., 0].amin(1), Xp[..., 0].amax(1)
    u = torch.rand(rounds, M, D, generator=gen, dtype=Xp.dtype,
                   device=Xp.device)
    xs = lo + (hi - lo) * u
    xs[..., 0] = a + (b - a) * u[..., 0]
    ys = field(xs.reshape(-1, D)).reshape(rounds, M) \
        + cfg["true_theta"][-1] * torch.randn(
            rounds, M, generator=gen, dtype=Xp.dtype, device=Xp.device)
    return xs, ys


def graph(cfg: dict) -> torch.Tensor:
    """The configuration's adjacency (float64, on the host): the
    reference's graph."""
    M = cfg["num_agents"]
    if cfg["graph"] != "path":
        raise ValueError(f"graph {cfg['graph']!r}: the benchmark builds the "
                         f"path graph of the paper's fleets")
    A = torch.zeros(M, M, dtype=torch.float64)
    idx = torch.arange(M - 1)
    A[idx, idx + 1] = A[idx + 1, idx] = 1.0
    return A


def host_generator(seed: int, stream: int) -> torch.Generator:
    """A host generator for stream `stream` of run seed `seed`."""
    return torch.Generator().manual_seed(
        (int(seed) * 1_000_003 + stream) & SEED_MASK)


def request_sizes(lo: int, hi: int, pool: int, n: int, seed: int):
    """n request sizes: blocks of `pool` sizes evenly spread over [lo, hi],
    each block in its own order drawn from the run's seed. Every seed
    serves the same multiset of sizes, in another order."""
    sizes = [lo + round((hi - lo) * i / (pool - 1)) for i in range(pool)]
    g = host_generator(seed, 1)
    out = []
    while len(out) < n:
        out += [sizes[i] for i in torch.randperm(pool, generator=g).tolist()]
    return out[:n]


def think_times(max_s: float, n: int, seed: int) -> list[float]:
    """n client think times, uniform on [0, max_s], from the run's seed."""
    g = host_generator(seed, 2)
    return (max_s * torch.rand(n, generator=g, dtype=torch.float64)).tolist()
