"""The paper's DAC-family decentralized prediction methods (§5):
DEC-PoE (Alg. 5), DEC-gPoE (Alg. 6), DEC-BCM (Alg. 7), DEC-rBCM (Alg. 8).

Counterpart of the DAC-family part of `repro.core.prediction.
decentralized`, in simulated-network mode (one process holds every agent).
Every method returns (mean, var, info) with the consensus residual
trajectory in info["dac_residuals"].

Two levels, as in the reference:
  `dec_*_from_moments` — consensus + aggregation on precomputed local
  moments (what the serving engine feeds from FittedExperts);
  `dec_rbcm` — the per-call wrapper with the raw-data signature that
  recomputes the local moments each time.
"""
from __future__ import annotations

import torch

from ..consensus.dac import dac
from ..gp.kernel import unpack
from .local import local_moments


def _prior_var(log_theta):
    _, sigma_f, _ = unpack(log_theta)
    return sigma_f**2


def _dac_sums(w0, A, iters: int):
    """DAC -> per-agent average estimates; returns (M * avg) = network sums.

    w0 (M, K): K parallel consensuses. Output (K,) sums plus residuals."""
    w, res = dac(w0, A, iters)
    return w0.shape[0] * w.mean(0), res


def _poe_beta(var, prior_var, m, M_eff, beta_mode: str):
    """Per-agent PoE-family weights beta_i (eq. 12-15); `m` is the agent
    mask as floats (all ones when unmasked), `M_eff` its per-query count."""
    if beta_mode == "one":
        return m
    if beta_mode == "avg":
        return m / M_eff
    if beta_mode == "entropy":
        return 0.5 * (torch.log(prior_var) - torch.log(var)) * m
    raise ValueError(beta_mode)


def _poe_summands(beta, mu, var):
    """The three per-agent consensus payloads [beta mu / var, beta / var,
    beta] -> (..., Nt, 3); their network sums assemble every PoE/BCM
    posterior."""
    return torch.stack([beta * mu / var, beta / var, beta], dim=-1)


def _poe_posterior(s_mu, s_prec, s_beta, prior_var, bcm_correction: bool):
    """Posterior from network sums of the `_poe_summands` payloads."""
    prec = s_prec + (1.0 - s_beta) / prior_var if bcm_correction \
        else s_prec                                       # (15) / (13)
    return s_mu / prec, 1.0 / prec                        # (14) / (12)


def _poe_family_from_moments(mu, var, prior_var, A, iters, beta_mode: str,
                             bcm_correction: bool, mask=None):
    m = torch.ones_like(mu) if mask is None else \
        torch.broadcast_to(mask, mu.shape).to(mu.dtype)
    beta = _poe_beta(var, prior_var, m, m.sum(0), beta_mode)
    w0 = _poe_summands(beta, mu, var)                     # (M, Nt, 3)
    sums, res = _dac_sums(w0.reshape(w0.shape[0], -1), A, iters)
    sums = sums.reshape(mu.shape[1], 3)
    mean, v = _poe_posterior(sums[:, 0], sums[:, 1], sums[:, 2], prior_var,
                             bcm_correction)
    return mean, v, {"dac_residuals": res}


def dec_poe_from_moments(mu, var, prior_var, A, iters=200, mask=None):
    """DEC-PoE (Alg. 5) on precomputed local moments."""
    return _poe_family_from_moments(mu, var, prior_var, A, iters, "one",
                                    False, mask)


def dec_gpoe_from_moments(mu, var, prior_var, A, iters=200, mask=None):
    """DEC-gPoE (Alg. 6) on precomputed local moments."""
    return _poe_family_from_moments(mu, var, prior_var, A, iters, "avg",
                                    False, mask)


def dec_bcm_from_moments(mu, var, prior_var, A, iters=200, mask=None):
    """DEC-BCM (Alg. 7) on precomputed local moments."""
    return _poe_family_from_moments(mu, var, prior_var, A, iters, "one",
                                    True, mask)


def dec_rbcm_from_moments(mu, var, prior_var, A, iters=200, mask=None):
    """DEC-rBCM (Alg. 8) on precomputed local moments."""
    return _poe_family_from_moments(mu, var, prior_var, A, iters, "entropy",
                                    True, mask)


def dec_rbcm(log_theta, Xp, yp, Xs, A, iters=200, mask=None):
    mu, var = local_moments(log_theta, Xp, yp, Xs)
    return dec_rbcm_from_moments(mu, var, _prior_var(log_theta), A, iters,
                                 mask)
