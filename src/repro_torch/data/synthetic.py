"""Synthetic data generation (paper §6.1).

Counterpart of `repro.data.synthetic`. Random draws come from an explicit
`torch.Generator`, whose device decides where the data is made; they are
not the JAX package's `jax.random` streams, so tests hold the sampler to
its distribution, not to the reference's numbers.

`gp_sample_field` draws from the exact GP prior when N is small and from a
random-Fourier-feature (RFF) approximation above `exact_max_n` (an RFF draw
with enough features is statistically indistinguishable from an exact draw
and costs O(N*F) instead of O(N^3)).

`sst_like_field` builds the SST stand-in: a smooth multi-scale 2-D field
with a meandering front, normalized like the paper's 400x400 km Atlantic
patch; it is generated, so no dataset is fetched.
"""
from __future__ import annotations

import math

import torch

from ..core.gp.kernel import se_kernel, unpack


def grid_inputs(n_side: int, lo=0.0, hi=2.0, dtype=torch.float64,
                device=None) -> torch.Tensor:
    xs = torch.linspace(lo, hi, n_side, dtype=dtype, device=device)
    X1, X2 = torch.meshgrid(xs, xs, indexing="ij")
    return torch.stack([X1.reshape(-1), X2.reshape(-1)], dim=1)


def random_inputs(generator: torch.Generator, n: int, D: int = 2, lo=0.0,
                  hi=2.0, dtype=torch.float64) -> torch.Tensor:
    """n points uniform on [lo, hi)^D, on the generator's device."""
    u = torch.rand(n, D, generator=generator, dtype=dtype,
                   device=generator.device)
    return lo + (hi - lo) * u


def gp_sample_field(generator: torch.Generator, X: torch.Tensor,
                    log_theta: torch.Tensor, exact_max_n: int = 4096,
                    rff_features: int = 4096):
    """Draw f ~ GP(0, k) at inputs X and add N(0, sigma_eps^2) noise -> y.

    X lives on the generator's device; returns (f, y), each (N,).
    """
    ls, sigma_f, sigma_eps = unpack(log_theta)
    n, D = X.shape
    kw = dict(generator=generator, dtype=X.dtype, device=X.device)
    if n <= exact_max_n:
        # float32 needs a much larger diagonal shift: at a few hundred
        # near-duplicate random inputs the SE Gram matrix is singular to
        # float32 precision; scaled by sigma_f^2 it tracks the Gram
        # diagonal and stays a nugget well below sigma_eps
        jit = 1e-8 if X.dtype == torch.float64 else 1e-3 * sigma_f**2
        K = se_kernel(X, X, log_theta) + jit * torch.eye(
            n, dtype=X.dtype, device=X.device)
        L = torch.linalg.cholesky(K)
        f = L @ torch.randn(n, **kw)
    else:
        f = rff_field(generator, log_theta, D, rff_features, X.dtype)(X)
    y = f + sigma_eps * torch.randn(n, **kw)
    return f, y


def rff_field(generator: torch.Generator, log_theta: torch.Tensor, D: int,
              rff_features: int = 4096, dtype=torch.float64):
    """One random-Fourier-feature draw f ~ GP(0, k), returned as a function
    of the inputs X (N, D) -> f (N,) on the generator's device: more points
    of the same field cost O(N * F). `gp_sample_field` draws its large
    fields through it, so the same generator state gives the same field.
    """
    ls, sigma_f, _ = unpack(log_theta)
    kw = dict(generator=generator, dtype=dtype, device=generator.device)
    # RFF for k(x,x') = sf^2 exp(-sum d^2/l^2): the spectral density is
    # Gaussian with std sqrt(2)/l per dimension
    W = torch.randn(rff_features, D, **kw) * (math.sqrt(2.0) / ls)
    b = 2 * math.pi * torch.rand(rff_features, **kw)
    w = torch.randn(rff_features, **kw)

    def field(X: torch.Tensor) -> torch.Tensor:
        phi = math.sqrt(2.0 / rff_features) * torch.cos(X @ W.T + b)
        return sigma_f * (phi @ w)
    return field


def sst_like_field(X: torch.Tensor, noise_std: float = 0.5,
                   generator: torch.Generator | None = None):
    """SST stand-in on [0,1]^2: warm-to-cold gradient + meandering front +
    eddies. Returns (f, y); f is deterministic, y = f + N(0, noise_std^2)
    iid from `generator` (default: a fresh generator on X's device seeded
    0, as the reference's default key is PRNGKey(0)). The paper's noise
    is N(0, 0.25), std 0.5: the same default."""
    x, z = X[:, 0], X[:, 1]
    front = (0.45 + 0.08 * torch.sin(4.0 * math.pi * x)
             + 0.05 * torch.cos(9.0 * x))
    f = (2.2 * torch.tanh((front - z) * 9.0)             # Gulf-Stream front
         + 0.8 * torch.sin(3.1 * x) * torch.cos(2.3 * z)  # mesoscale
         + 0.4 * torch.sin(7.9 * x + 1.3) * torch.sin(6.1 * z + 0.7)
         + 0.15 * torch.cos(15.0 * x) * torch.cos(13.0 * z))
    if generator is None:
        generator = torch.Generator(X.device).manual_seed(0)
    y = f + noise_std * torch.randn(f.shape, generator=generator,
                                    dtype=f.dtype, device=f.device)
    return f, y
