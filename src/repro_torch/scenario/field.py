"""The latent ground-truth field a mission traverses.

Counterpart of `repro.scenario.field`: one seeded random-Fourier-feature
draw from the GP prior, kept as a continuous function, so the driver
evaluates the same draw at trajectory positions (observations), at
held-out eval points (the accuracy curves compare predictions against the
noiseless latent f) and at any replayed position. For the SE kernel the
spectral density is Gaussian with std sqrt(2)/l per dimension.

The reference draws the features with `jax.random`; here they are drawn
on the host from a numpy Generator seeded by (cfg.seed, stream id), as
`trajectories.agent_paths` draws the paths, so the CPU and the card
evaluate the same field. `f` computes in torch on the field's device, in
the dtype the caller names (the reference takes the widest float its
x64 flag allows).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.gp.kernel import pack, unpack
from ..device import resolve_device

_FIELD_STREAM = 0xF1E1D


class LatentField:
    """f ~ GP(0, k_SE(theta)) via F random Fourier features:
    f(X) = sigma_f sqrt(2/F) cos(X W^T + b) w, with W (F, D) already
    scaled by sqrt(2)/l. `observe` adds the field's N(0, sigma_eps^2)
    sensor noise to a given standard-normal draw."""

    def __init__(self, log_theta, W, b, w, *, dtype=torch.float64,
                 device=None):
        dev = resolve_device(device)
        kw = dict(dtype=dtype, device=dev)
        self.log_theta = torch.tensor(np.asarray(log_theta), **kw)
        _, self.sigma_f, self.sigma_eps = unpack(self.log_theta)
        self.W, self.b, self.w = (torch.tensor(np.asarray(a), **kw)
                                  for a in (W, b, w))

    @property
    def dtype(self) -> torch.dtype:
        return self.W.dtype

    @property
    def device(self) -> torch.device:
        return self.W.device

    def f(self, X) -> torch.Tensor:
        """Noiseless latent field at X (n, D) -> (n,)."""
        X = torch.as_tensor(X, dtype=self.dtype, device=self.device)
        F = self.W.shape[0]
        phi = math.sqrt(2.0 / F) * torch.cos(X @ self.W.T + self.b[None, :])
        return self.sigma_f * (phi @ self.w)

    def observe(self, X, eps) -> torch.Tensor:
        """Noisy sensor reading y = f(X) + sigma_eps * eps, eps a
        standard-normal draw of shape (n,)."""
        eps = torch.as_tensor(eps, dtype=self.dtype, device=self.device)
        return self.f(X) + self.sigma_eps * eps


def make_field(cfg, *, dtype=torch.float64, device=None) -> LatentField:
    """The scenario's field: one draw, derived from cfg.seed alone."""
    ls = np.asarray(cfg.field_theta[:-2], dtype=np.float64)
    rng = np.random.default_rng([int(cfg.seed), _FIELD_STREAM])
    F, D = int(cfg.field_features), ls.shape[0]
    W = rng.standard_normal((F, D)) * (np.sqrt(2.0) / ls)[None, :]
    b = rng.uniform(0.0, 2.0 * np.pi, F)
    w = rng.standard_normal(F)
    lt = pack(list(cfg.field_theta[:-2]), cfg.field_theta[-2],
              cfg.field_theta[-1], dtype=torch.float64)
    return LatentField(lt, W, b, w, dtype=dtype, device=device)
