"""Sparse pseudo-representation experts, counterpart of
`repro.core.sparse.experts`: each agent compresses its Ni points to
m << Ni inducing inputs Z_i with Titsias-style variational factors, so a
fit costs O(Ni m^2) instead of O(Ni^3) and an agent exchanges O(m).

`SparseExperts` is the counterpart of `prediction.engine.FittedExperts`:
the same (M, ...) agent-leading contract and fit-once / serve-many split,
served by the same PredictionEngine through isinstance dispatch. Per agent
i it caches

  Lmm_i   = chol(K(Z_i, Z_i) + jit I)                    (m, m)
  LS_i    = chol(Sigma_i + jit I),
            Sigma_i = Kmm + sigma_eps^-2 Kmn Knm         (m, m)
  c_i     = sigma_eps^-2 Sigma_i^-1 Kmn y_i              (m,)
  tr_corr = tr(Knn) - tr(Kmm^-1 Kmn Knm)                 scalar

so the SGPR posterior at a query x is mu = k_xZ c and
var = sigma_f^2 - k_xZ^T (Kmm^-1 - Sigma^-1) k_xZ; tr_corr is the Titsias
diagonal-correction trace (-> 0 as m -> Ni).

The only O(Ni) work is the Kmn statistics, streamed one (M, m, 4096)
panel at a time through `kernels.ops.kmn_stats_agents` (the hand-written
rbf_gram kernel on the card, one launch per panel for the whole fleet):
the (Ni, Ni) Gram is never formed. The reference vmaps over agents; here
the agent axis is a batch dimension.

This module does not import core.prediction: prediction.engine imports
it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...kernels.ops import kmn_stats_agents, rbf_matvec_agents
from ..gp.kernel import se_kernel, unpack
from ..gp.nll import cho_solve, cholesky


class SparseExperts(NamedTuple):
    """Per-agent sparse factors, computed once after training."""
    log_theta: torch.Tensor   # (D+2,) shared hyperparameters
    Z: torch.Tensor           # (M, m, D) inducing inputs
    Lmm: torch.Tensor         # (M, m, m) chol(Kmm + jit I)
    LS: torch.Tensor          # (M, m, m) chol(Sigma + jit I)
    c: torch.Tensor           # (M, m)   posterior mean weights
    tr_corr: torch.Tensor     # (M,)     Titsias diagonal-correction trace

    @property
    def num_agents(self) -> int:
        return self.Z.shape[0]

    @property
    def prior_var(self) -> torch.Tensor:
        return torch.exp(self.log_theta[-2]) ** 2

    @property
    def Xp(self) -> torch.Tensor:
        """Inducing inputs stand in for the training inputs wherever the
        engine needs only representative geometry (the streamed mean)."""
        return self.Z

    @property
    def Kcross(self):
        """Sparse experts carry no dense cross-Gram cache: the low-rank
        NPAE path replaces it (lowrank.npae_terms_lowrank)."""
        return None

    def to(self, device) -> "SparseExperts":
        return SparseExperts(*(t.to(device) for t in self))


def _agent_seed(seed: int, agent: int) -> int:
    """A 63-bit seed for agent `agent`'s stream, decorrelated from the
    other agents' (the role of the reference's fold_in(seed, agent))."""
    return int(np.random.SeedSequence([seed, agent]).generate_state(
        2, np.uint64)[0] >> np.uint64(1))


def select_inducing(Xp: torch.Tensor, m: int, method: str = "stride",
                    seed: int = 0) -> torch.Tensor:
    """Per-agent inducing inputs Z (M, m, D) from the training inputs.

    "stride"  — evenly strided subset (deterministic; distinct indices for
                m <= Ni, m = Ni recovering the full set), exactly the
                reference's indices;
    "random"  — per-agent uniform subset without replacement, each agent
                drawing from its own torch.Generator stream seeded from
                (seed, agent). The port cannot reproduce jax.random, so
                this is the reference's distribution, not its numbers.

    m is clamped to Ni.
    """
    M, N = Xp.shape[0], Xp.shape[1]
    m = min(int(m), N)
    if method == "stride":
        idx = np.round(np.linspace(0, N - 1, m)).astype(np.int64)
        return Xp[:, torch.from_numpy(idx).to(Xp.device), :]
    if method == "random":
        Z = []
        for i in range(M):
            g = torch.Generator(Xp.device).manual_seed(_agent_seed(seed, i))
            Z.append(Xp[i, torch.randperm(N, generator=g,
                                          device=Xp.device)[:m]])
        return torch.stack(Z)
    raise ValueError(f"unknown inducing_init {method!r} "
                     f"(choices: 'stride', 'random')")


def _rel_jitter(sigma_f, dtype, jitter):
    """Jitter relative to the prior scale, floored at 8 eps — the same
    conditioning policy as aggregation.npae's per-query solve."""
    eps = torch.finfo(dtype).eps
    return (jitter + 8.0 * eps) * sigma_f**2


def _tri(L, B):
    """L^-1 B for lower-triangular L."""
    return torch.linalg.solve_triangular(L, B, upper=False)


def fit_sparse_experts(log_theta, Xp, yp, Z, jitter: float = 1e-8,
                       block: int = 4096) -> SparseExperts:
    """Factorize every agent's sparse model once. Xp (M, Ni, D),
    yp (M, Ni), Z (M, m, D) -> SparseExperts.

    Cost per agent: O(Ni m) kernel evaluations streamed in (m, block)
    panels (`kmn_stats_agents`), O(Ni m^2) for the Kmn Knm accumulation,
    O(m^3) for the two Cholesky factors. No O(Ni^2) anywhere.
    """
    ls, sigma_f, sigma_eps = unpack(log_theta)
    jit_eff = _rel_jitter(sigma_f, Xp.dtype, jitter)
    m = Z.shape[1]
    eye = torch.eye(m, dtype=Xp.dtype, device=Xp.device)
    Kmm = se_kernel(Z, Z, log_theta)
    B, b = kmn_stats_agents(Z, Xp, yp, ls, sigma_f, bn=block)
    Lmm = cholesky(Kmm + jit_eff * eye)
    # chol(Sigma) through the whitened form: Sigma = Kmm + B / sigma_eps^2
    # is catastrophically ill-conditioned at large Ni (a direct chol NaNs
    # at Ni ~ 1e5), but W = Lmm^-1 B Lmm^-T / sigma_eps^2 gives I + W with
    # minimum eigenvalue >= 1, and LS = Lmm chol(I + W) is an exact lower
    # triangular factor of Sigma + jit I
    W = _tri(Lmm, B)
    W = _tri(Lmm, W.mT)
    W = 0.5 * (W + W.mT) / sigma_eps**2
    # W's eigenvalues are >= 0, but B's rounding amplified through Kmm's
    # near-null space (cond(Lmm)^2) can push computed eigenvalues of I + W
    # below 1 at Ni ~ 1e5: floor them at the provable minimum 1, so the
    # Cholesky always exists (a no-op when conditioning is benign)
    ew, V = torch.linalg.eigh(eye + W)
    Bw = (V * torch.clamp(ew, min=1.0)[..., None, :]) @ V.mT
    LS = Lmm @ cholesky(Bw)
    c = cho_solve(LS, b) / sigma_eps**2
    # qnn = tr(Kmm^-1 B) = tr(W) sigma_eps^2; the true correction is >= 0
    tr_corr = torch.clamp(
        Xp.shape[1] * sigma_f**2
        - torch.diagonal(W, dim1=-2, dim2=-1).sum(-1) * sigma_eps**2,
        min=0.0)
    return SparseExperts(log_theta, Z, Lmm, LS, c, tr_corr)


def _sparse_v(log_theta, Z, Lmm, LS, Xs):
    """k(Z_i, Xs) (M, m, Nt) and the column sums of (Lmm^-1 k)^2 and
    (LS^-1 k)^2 (M, Nt)."""
    ks = se_kernel(Z, Xs[None], log_theta)
    v1 = _tri(Lmm, ks)
    v2 = _tri(LS, ks)
    return ks, (v1 * v1).sum(-2), (v2 * v2).sum(-2)


def sparse_moments_cached(log_theta, Z, Lmm, LS, c, Xs,
                          stream_mean: bool = False):
    """Local SGPR moments from cached sparse factors — the sparse analogue
    of `prediction.local.local_moments_cached`, feeding the same
    PoE/BCM aggregation. Returns (mu, var), each (M, Nt).

    var = sigma_f^2 - k^T Kmm^-1 k + k^T Sigma^-1 k, floored at 1e-12 like
    the dense path. `stream_mean=True` takes the mean k(Xs, Z_i) c_i
    through the fused rbf_matvec kernel, with Z standing in for Xp.
    """
    ls, sigma_f, _ = unpack(log_theta)
    sf2 = sigma_f**2
    ks, s1, s2 = _sparse_v(log_theta, Z, Lmm, LS, Xs)
    var = torch.clamp(sf2 - s1 + s2, min=1e-12)
    if stream_mean:
        return rbf_matvec_agents(Xs, Z, c, ls, sf2).to(Xs.dtype), var
    return torch.einsum("mnt,mn->mt", ks, c), var


def sparse_scores(log_theta, Z, Lmm, LS, Xs):
    """CBNN covariance scores (eq. 39 semantics: sigma_f^2 - var_i) from
    sparse factors -> (M, Nt), on the scale of the dense scores."""
    _, s1, s2 = _sparse_v(log_theta, Z, Lmm, LS, Xs)
    return s1 - s2
