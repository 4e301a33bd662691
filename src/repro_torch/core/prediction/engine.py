"""Factor-cached, query-tiled prediction engine — the serving hot path.

Counterpart of `repro.core.prediction.engine` for the DAC family:

  FittedExperts    — per-agent Cholesky L_i and weights alpha_i =
                     C_i^{-1} y_i, computed once after training
                     (`fit_experts`), or carried over from the JAX
                     package's fit (`FittedExperts.from_numpy`).
  map_query_tiles  — a loop over fixed-size query tiles: peak memory is
                     O(chunk * M * Ni) at any Nt.
  PredictionEngine — serving front-end: poe gpoe bcm rbcm and their
                     centralized references cen_*, from FittedExperts or
                     from sparse pseudo-representation experts
                     (core.sparse.SparseExperts, isinstance dispatch), and
                     npae_sparse, the low-rank NPAE of sparse fleets. With
                     `stream_mean=True` the posterior means ride the fused
                     Gram-matvec kernel (kernels.rbf_matvec), one launch
                     per query tile for the whole fleet. `swap_experts`
                     replaces the served factors of a streaming fleet
                     (core.online, dense only) in place; `rewire` applies
                     a membership change (new adjacency, new M).

PyTorch runs eagerly, so the reference's jit cache and trace counters have
no counterpart here.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

from ...device import resolve_device
from ..gp.kernel import unpack
from . import aggregation as agg
from .decentralized import (dec_bcm_from_moments, dec_gpoe_from_moments,
                            dec_poe_from_moments, dec_rbcm_from_moments)
from .local import chol_factors, local_moments_cached, stream_means
from ..sparse import (SparseExperts, npae_terms_lowrank,
                      sparse_moments_cached)


class FittedExperts(NamedTuple):
    """Per-agent state computed once after training."""
    log_theta: torch.Tensor   # (D+2,)
    Xp: torch.Tensor          # (M, Ni, D)
    yp: torch.Tensor          # (M, Ni)
    L: torch.Tensor           # (M, Ni, Ni)  chol(K(X_i, X_i) + sigma_eps^2 I)
    alpha: torch.Tensor       # (M, Ni)      C_i^{-1} y_i

    @property
    def num_agents(self) -> int:
        return self.Xp.shape[0]

    @property
    def prior_var(self) -> torch.Tensor:
        _, sigma_f, _ = unpack(self.log_theta)
        return sigma_f**2

    def to(self, device) -> "FittedExperts":
        return FittedExperts(*(t.to(device) for t in self))

    @classmethod
    def from_numpy(cls, arrays: Mapping, device=None) -> "FittedExperts":
        """Carry a fitted fleet across from numpy arrays keyed by field name
        (log_theta, Xp, yp, L, alpha) — e.g. the JAX package's
        FittedExperts via `np.asarray` — onto `device` (default: cuda)."""
        dev = resolve_device(device)
        return cls(*(torch.tensor(arrays[name], device=dev)
                     for name in cls._fields))


def fit_experts(log_theta, Xp, yp, jitter: float = 1e-8) -> FittedExperts:
    """Factorize every agent's kernel matrix once; reused by all methods."""
    L, alpha = chol_factors(log_theta, Xp, yp, jitter)
    return FittedExperts(log_theta, Xp, yp, L, alpha)


def map_query_tiles(tile_fn, Xs, chunk: int):
    """Apply `tile_fn((chunk, D)) -> (per_query dict, reduced dict)` over
    fixed-size query tiles in order.

    Per-query leaves have leading axis `chunk`; they are stitched along the
    query axis and the padding tail is stripped. Reduced leaves are
    combined with an elementwise max over tiles (the worst tile).
    """
    Nt = Xs.shape[0]
    n_tiles = -(-Nt // chunk)
    pad = n_tiles * chunk - Nt
    # edge-replicate the tail: padded slots duplicate the LAST REAL query,
    # so the max-reduced residuals describe the served workload
    padded = torch.cat([Xs, Xs[-1:].expand(pad, -1)]) if pad else Xs
    outs = [tile_fn(padded[t * chunk:(t + 1) * chunk])
            for t in range(n_tiles)]
    perq = {k: torch.cat([o[0][k] for o in outs])[:Nt] for k in outs[0][0]}
    reduced = {k: torch.stack([o[1][k] for o in outs]).amax(0)
               for k in outs[0][1]}
    return perq, reduced


_DAC_CORES = {"poe": dec_poe_from_moments, "gpoe": dec_gpoe_from_moments,
              "bcm": dec_bcm_from_moments, "rbcm": dec_rbcm_from_moments}


class PredictionEngine:
    """Serving front-end over FittedExperts or SparseExperts: query-tiled
    DAC-family methods and the low-rank NPAE.

    Decentralized: poe gpoe bcm rbcm (paper Alg. 5-8), from dense or
    sparse factors; npae_sparse from sparse factors only.
    Centralized references: cen_poe cen_gpoe cen_bcm cen_rbcm.

    The experts and the adjacency move to `device` (default: cuda) at
    construction; queries are moved there per call.
    """

    METHODS = ("poe", "gpoe", "bcm", "rbcm", "npae_sparse",
               "cen_poe", "cen_gpoe", "cen_bcm", "cen_rbcm")

    def __init__(self, fitted: FittedExperts | SparseExperts, A, *,
                 chunk: int = 256, dac_iters: int = 200,
                 stream_mean: bool = False, npae_jitter: float = 1e-6,
                 device=None):
        self.device = resolve_device(device)
        self.fitted = fitted.to(self.device)
        self.A = torch.as_tensor(A).to(self.device, torch.float64)
        if self.A.shape[0] != self.fitted.num_agents:
            raise ValueError(f"adjacency for {self.A.shape[0]} agents vs "
                             f"{self.fitted.num_agents} fitted agents")
        self.chunk = int(chunk)
        self.dac_iters = int(dac_iters)
        self.stream_mean = bool(stream_mean)
        self.npae_jitter = float(npae_jitter)

    def _queries(self, Xs):
        """Queries as a tensor on the engine's device in the experts'
        dtype."""
        return torch.as_tensor(Xs, dtype=self.fitted.Xp.dtype,
                               device=self.device)

    def _moments(self, f, Xq):
        """Local expert moments (M, Nt) from dense or sparse factors: the
        isinstance dispatch that lets every PoE/BCM aggregation serve both
        fleets."""
        if isinstance(f, SparseExperts):
            return sparse_moments_cached(f.log_theta, f.Z, f.Lmm, f.LS, f.c,
                                         Xq, stream_mean=self.stream_mean)
        return local_moments_cached(f.log_theta, f.Xp, f.L, f.alpha, Xq,
                                    stream_mean=self.stream_mean)

    def _tile(self, method: str, Xq):
        f = self.fitted
        pv = f.prior_var
        if method == "npae_sparse":
            # low-rank NPAE: the cross-covariance through the pseudo-points,
            # solved by the same aggregation core as the exact family
            mu, kA, CA = npae_terms_lowrank(f.log_theta, f.Z, f.Lmm, f.LS,
                                            f.c, Xq)
            mean, v = agg.npae(mu, kA, CA, pv, jitter=self.npae_jitter)
            return {"mean": mean, "var": v}, {}
        mu, var = self._moments(f, Xq)
        if method in _DAC_CORES:
            mean, v, info = _DAC_CORES[method](mu, var, pv, self.A,
                                               iters=self.dac_iters)
            return ({"mean": mean, "var": v},
                    {"dac_residual": info["dac_residuals"][-1]})
        fn = getattr(agg, method[4:])
        mean, v = fn(mu, var, pv) if method in ("cen_bcm", "cen_rbcm") \
            else fn(mu, var)
        return {"mean": mean, "var": v}, {}

    def predict(self, method: str, Xs):
        """Serve one query batch -> (mean (Nt,), var (Nt,), info).

        info carries the worst-tile final DAC residual ("dac_residual") for
        the decentralized methods."""
        if method not in self.METHODS:
            raise ValueError(f"unknown prediction method {method!r}; "
                             f"one of {self.METHODS}")
        if method == "npae_sparse" and not isinstance(self.fitted,
                                                      SparseExperts):
            raise ValueError(
                "npae_sparse serves from SparseExperts only — fit with "
                "FleetConfig(sparse_m=...) (or fit_sparse_experts) to build "
                "the pseudo-representation factors")
        Xs = self._queries(Xs)
        perq, red = map_query_tiles(lambda Xq: self._tile(method, Xq), Xs,
                                    self.chunk)
        return perq["mean"], perq["var"], red

    def swap_experts(self, fitted: FittedExperts):
        """Hot-swap the served factors (the streaming case:
        `OnlineExperts.to_fitted()` after observe/evict events).

        The replacement must match the served experts field for field in
        shape, dtype and device; the adjacency and everything else the
        engine holds stay as they are. Raises otherwise — a changed agent
        count or window is a membership change: use `rewire`."""
        if not isinstance(fitted, FittedExperts):
            raise TypeError(f"swap_experts: want FittedExperts, got "
                            f"{type(fitted).__name__}")
        for name, new, old in zip(FittedExperts._fields, fitted,
                                  self.fitted):
            if (new.shape, new.dtype, new.device) != \
                    (old.shape, old.dtype, old.device):
                raise ValueError(
                    f"swap_experts: {name} changed from {tuple(old.shape)} "
                    f"{old.dtype} on {old.device} to {tuple(new.shape)} "
                    f"{new.dtype} on {new.device} (agent membership or "
                    f"window geometry) — use rewire()")
        self.fitted = fitted

    def rewire(self, A, fitted: FittedExperts | None = None):
        """Apply a membership or topology change (core.online.join /
        leave): a new adjacency and optionally a new fleet, on the engine's
        device. The DAC consensus reads A at every call, so this is all it
        takes to re-sync it to the new graph."""
        experts = fitted if fitted is not None else self.fitted
        A = torch.as_tensor(A)
        if experts.num_agents != A.shape[0]:
            raise ValueError(f"rewire: {experts.num_agents} fitted agents "
                             f"vs adjacency for {A.shape[0]}")
        self.A = A.to(self.device, torch.float64)
        if fitted is not None:
            self.fitted = fitted.to(self.device)

    def posterior_means_streamed(self, Xs):
        """Per-agent streamed posterior means (M, Nt) via the fused
        Gram-matvec kernel — the O(Ni + Nt) mean-only path (O(m + Nt) for
        sparse experts, whose weights c ride their inducing inputs)."""
        f = self.fitted
        w = f.c if isinstance(f, SparseExperts) else f.alpha
        return stream_means(f.log_theta, f.Xp, w, self._queries(Xs))
