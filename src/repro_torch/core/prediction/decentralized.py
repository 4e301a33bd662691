"""The paper's 13 decentralized GP prediction methods (§5).

DAC family (strongly connected graphs):
  DEC-PoE (Alg. 5), DEC-gPoE (Alg. 6), DEC-BCM (Alg. 7), DEC-rBCM (Alg. 8),
  DEC-grBCM (Alg. 9)
NPAE family (strongly complete for JOR/PM):
  DEC-NPAE (Alg. 10), DEC-NPAE* (Alg. 11-12, PM-estimated omega*)
CBNN nearest-neighbor family (Alg. 13-18):
  DEC-NN-{PoE, gPoE, BCM, rBCM, grBCM} (DAC on the CBNN subset)
  DEC-NN-NPAE (DALE, strongly connected suffices)

Counterpart of `repro.core.prediction.decentralized`, in simulated-network
mode (one process holds every agent). Excluded CBNN agents still relay
DAC messages with a zero contribution, which converges to sum_selected/M;
multiplying by M recovers the selected-agent sums exactly.

Every method returns (mean, var, info) with the consensus residuals in
info. Each exists at two levels, as in the reference:
  `dec_*_from_moments` / `dec_*_from_terms` — consensus + aggregation on
  precomputed local quantities (what the serving engine feeds from
  FittedExperts);
  `dec_*` — per-call wrappers with the raw-data signatures that recompute
  the local quantities each time.
The per-query NPAE systems are solved for every query of a tile at once
(batched JOR, PM and DALE), the mean and k_A right-hand sides stacked.

The cores take the reference's degraded-mode hooks: `dac_fn` (the
signature of `_dac_sums`) swaps the consensus readout for
`consensus.degraded`'s masked one, and dec_nn_npae_from_terms' `readout`
restricts the averaged solution copies to the surviving component. None
keeps the exact path.
"""
from __future__ import annotations

import torch

from ...obs.tracing import span
from ..consensus.dac import dac
from ..consensus.dale import dale
from ..consensus.jor import jor
from ..consensus.power_method import optimal_omega
from ..gp.kernel import unpack
from .cbnn import cbnn_mask
from .local import local_moments, npae_terms


def _prior_var(log_theta):
    _, sigma_f, _ = unpack(log_theta)
    return sigma_f**2


def _dac_sums(w0, A, iters: int):
    """DAC -> per-agent average estimates; returns (M * avg) = network sums.

    w0 (M, K): K parallel consensuses. Output (K,) sums plus residuals."""
    with span("consensus.dac"):
        w, res = dac(w0, A, iters)
        return w0.shape[0] * w.mean(0), res


# ---------------------------------------------------------------------------
# DAC family — cores on precomputed moments
# ---------------------------------------------------------------------------

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


def _grbcm_beta(var_aug, var_c, m, agent_index):
    """grBCM weights (eq. 16-17): beta_1 = 1 for the first augmented
    expert, entropy weights against the communication expert otherwise."""
    beta = 0.5 * (torch.log(var_c)[None] - torch.log(var_aug))
    first = (agent_index == 0)[:, None]
    return torch.where(first, torch.ones_like(beta), beta) * m


def _grbcm_posterior(s_mu, s_prec, s_beta, mu_c, var_c):
    """grBCM posterior from network sums of the `_poe_summands` payloads
    on augmented-expert moments."""
    prec = s_prec + (1.0 - s_beta) / var_c                 # (17)
    mean = (s_mu - (s_beta - 1.0) * mu_c / var_c) / prec   # (16)
    return mean, 1.0 / prec


def _mask_floats(mask, like):
    return torch.ones_like(like) if mask is None else \
        torch.broadcast_to(mask, like.shape).to(like.dtype)


def _poe_family_from_moments(mu, var, prior_var, A, iters, beta_mode: str,
                             bcm_correction: bool, mask=None, dac_fn=None):
    m = _mask_floats(mask, mu)
    beta = _poe_beta(var, prior_var, m, m.sum(0), beta_mode)
    w0 = _poe_summands(beta, mu, var)                     # (M, Nt, 3)
    sums_fn = _dac_sums if dac_fn is None else dac_fn
    sums, res = sums_fn(w0.reshape(w0.shape[0], -1), A, iters)
    sums = sums.reshape(mu.shape[1], 3)
    mean, v = _poe_posterior(sums[:, 0], sums[:, 1], sums[:, 2], prior_var,
                             bcm_correction)
    return mean, v, {"dac_residuals": res}


def dec_poe_from_moments(mu, var, prior_var, A, iters=200, mask=None,
                         dac_fn=None):
    """DEC-PoE (Alg. 5) on precomputed local moments."""
    return _poe_family_from_moments(mu, var, prior_var, A, iters, "one",
                                    False, mask, dac_fn)


def dec_gpoe_from_moments(mu, var, prior_var, A, iters=200, mask=None,
                          dac_fn=None):
    """DEC-gPoE (Alg. 6) on precomputed local moments."""
    return _poe_family_from_moments(mu, var, prior_var, A, iters, "avg",
                                    False, mask, dac_fn)


def dec_bcm_from_moments(mu, var, prior_var, A, iters=200, mask=None,
                         dac_fn=None):
    """DEC-BCM (Alg. 7) on precomputed local moments."""
    return _poe_family_from_moments(mu, var, prior_var, A, iters, "one",
                                    True, mask, dac_fn)


def dec_rbcm_from_moments(mu, var, prior_var, A, iters=200, mask=None,
                          dac_fn=None):
    """DEC-rBCM (Alg. 8) on precomputed local moments."""
    return _poe_family_from_moments(mu, var, prior_var, A, iters, "entropy",
                                    True, mask, dac_fn)


def dec_grbcm_from_moments(mu_aug, var_aug, mu_c, var_c, A, iters=200,
                           mask=None, dac_fn=None):
    """DEC-grBCM (Alg. 9) core: three DACs on augmented-expert quantities.

    mu_aug/var_aug (M, Nt) are the AUGMENTED experts' moments; mu_c/var_c
    (Nt,) the communication expert's. `dac_fn` (the signature of
    `_dac_sums`) swaps the consensus readout: the degraded-mode hook."""
    m = _mask_floats(mask, mu_aug)
    index = torch.arange(mu_aug.shape[0], device=mu_aug.device)
    beta = _grbcm_beta(var_aug, var_c, m, index)
    w0 = _poe_summands(beta, mu_aug, var_aug)
    sums_fn = _dac_sums if dac_fn is None else dac_fn
    sums, res = sums_fn(w0.reshape(w0.shape[0], -1), A, iters)
    sums = sums.reshape(mu_aug.shape[1], 3)
    mean, v = _grbcm_posterior(sums[:, 0], sums[:, 1], sums[:, 2], mu_c,
                               var_c)
    return mean, v, {"dac_residuals": res}


# ---------------------------------------------------------------------------
# DAC family — per-call wrappers
# ---------------------------------------------------------------------------

def dec_poe(log_theta, Xp, yp, Xs, A, iters=200, mask=None):
    mu, var = local_moments(log_theta, Xp, yp, Xs)
    return dec_poe_from_moments(mu, var, _prior_var(log_theta), A, iters,
                                mask)


def dec_gpoe(log_theta, Xp, yp, Xs, A, iters=200, mask=None):
    mu, var = local_moments(log_theta, Xp, yp, Xs)
    return dec_gpoe_from_moments(mu, var, _prior_var(log_theta), A, iters,
                                 mask)


def dec_bcm(log_theta, Xp, yp, Xs, A, iters=200, mask=None):
    mu, var = local_moments(log_theta, Xp, yp, Xs)
    return dec_bcm_from_moments(mu, var, _prior_var(log_theta), A, iters,
                                mask)


def dec_rbcm(log_theta, Xp, yp, Xs, A, iters=200, mask=None):
    mu, var = local_moments(log_theta, Xp, yp, Xs)
    return dec_rbcm_from_moments(mu, var, _prior_var(log_theta), A, iters,
                                 mask)


def dec_grbcm(log_theta, Xp_aug, yp_aug, Xc, yc, Xs, A, iters=200,
              mask=None):
    """DEC-grBCM (Alg. 9): three DACs on augmented-expert quantities."""
    mu_aug, var_aug = local_moments(log_theta, Xp_aug, yp_aug, Xs)
    mu_c, var_c = local_moments(log_theta, Xc[None], yc[None], Xs)
    return dec_grbcm_from_moments(mu_aug, var_aug, mu_c[0], var_c[0], A,
                                  iters, mask)


# ---------------------------------------------------------------------------
# NPAE family
# ---------------------------------------------------------------------------

def _masked_system(CA, mkT):
    """Decouple masked agents from the per-query NPAE systems (CA
    (Nt, M, M), mkT (Nt, M)): masked rows and columns zeroed, diagonal set
    to 1, so the live block solves exactly the masked system and masked
    entries settle at 0."""
    eye = torch.eye(CA.shape[-1], dtype=CA.dtype, device=CA.device)
    return CA * (mkT[:, :, None] * mkT[:, None, :]) \
        + eye[None] * (1.0 - mkT)[:, None, :]


def _npae_consensus(mu, kA, CA, prior_var, A, solver, dac_iters, mask=None,
                    dac_fn=None):
    """Shared scaffold: per-query linear solves, then DAC to assemble the
    dot products. `mask` (M, Nt) 0/1 excludes agents from the system
    (decoupled rows, zeroed payloads); `dac_fn` swaps the consensus
    readout (`_dac_sums` signature). Both are the degraded-mode hooks."""
    if mask is not None:
        mk = mask.to(mu.dtype)
        CA = _masked_system(CA, mk.T)
        mu = mu * mk
        kA = kA * mk
    q, solver_info = solver(CA, torch.stack([mu.T, kA.T], -1))  # (Nt, M, 2)
    # each agent holds w_i = [k_A]_i * q_i; DAC recovers the dot products
    w0 = kA[..., None] * q.transpose(0, 1)                 # (M, Nt, 2)
    sums_fn = _dac_sums if dac_fn is None else dac_fn
    sums, res = sums_fn(w0.reshape(w0.shape[0], -1), A, dac_iters)
    sums = sums.reshape(mu.shape[1], 2)
    mean = sums[:, 0]                                      # k_A^T C_A^-1 mu (20)
    var = torch.clamp(prior_var - sums[:, 1], min=1e-12)   # (21)
    return mean, var, {"dac_residuals": res, **solver_info}


def _rel_jitter(C, rel=1e-6):
    """Relative diagonal jitter: C_A can be near-singular when agents are
    weakly correlated to a query (the NPAE family's approximation error);
    scaling by the mean diagonal keeps JOR/DALE well-posed across data
    scales."""
    eye = torch.eye(C.shape[-1], dtype=C.dtype, device=C.device)
    scale = torch.diagonal(C, dim1=-2, dim2=-1).mean(-1)
    return C + (1e-12 + rel * scale)[..., None, None] * eye


def _jor_info(res, om, with_residuals: bool):
    """res (Nt, jor_iters): the worst query's final residual, and with
    `with_residuals` the worst query per round."""
    info = {"jor_residual": res[:, -1].max(), "omega": om}
    if with_residuals:
        info["jor_residuals"] = res.amax(0)
    return info


def dec_npae_from_terms(mu, kA, CA, prior_var, A, jor_iters=500,
                        dac_iters=200, omega=None, jitter=1e-6,
                        with_residuals=False, mask=None, dac_fn=None):
    """DEC-NPAE (Alg. 10) core: JOR (strongly complete) + DAC on
    precomputed NPAE terms. Lemma 2 default omega = 2/M * 0.999.

    `with_residuals=True` adds the per-round JOR residual trajectory
    "jor_residuals" (jor_iters,), the worst query per round, beside the
    final "jor_residual". `mask`/`dac_fn` are the degraded-mode hooks
    (see `_npae_consensus`)."""
    M = mu.shape[0]
    om = (2.0 / M) * 0.999 if omega is None else omega

    def solver(CA, b):
        q, res = jor(_rel_jitter(CA, jitter), b, om, jor_iters)
        return q, _jor_info(res, om, with_residuals)

    return _npae_consensus(mu, kA, CA, prior_var, A, solver, dac_iters,
                           mask=mask, dac_fn=dac_fn)


def dec_npae_star_from_terms(mu, kA, CA, prior_var, A, jor_iters=500,
                             dac_iters=200, pm_iters=100, jitter=1e-6,
                             with_residuals=False, mask=None, dac_fn=None):
    """DEC-NPAE* (Alg. 12) core: PM/IPM estimate omega* = 2/(lmax+lmin)
    per query, then JOR with the optimal relaxation (Lemma 3).
    `mask`/`dac_fn` are the degraded-mode hooks."""

    def solver(CA, b):
        H = _rel_jitter(CA, jitter)
        oms = optimal_omega(H, pm_iters)                   # (Nt,)
        q, res = jor(H, b, oms, jor_iters)
        return q, _jor_info(res, oms, with_residuals)

    return _npae_consensus(mu, kA, CA, prior_var, A, solver, dac_iters,
                           mask=mask, dac_fn=dac_fn)


def dec_npae(log_theta, Xp, yp, Xs, A, jor_iters=500, dac_iters=200,
             omega=None, jitter=1e-6):
    """DEC-NPAE (Alg. 10): JOR (strongly complete) + DAC."""
    mu, kA, CA = npae_terms(log_theta, Xp, yp, Xs)
    return dec_npae_from_terms(mu, kA, CA, _prior_var(log_theta), A,
                               jor_iters, dac_iters, omega, jitter)


def dec_npae_star(log_theta, Xp, yp, Xs, A, jor_iters=500, dac_iters=200,
                  pm_iters=100, jitter=1e-6):
    """DEC-NPAE* (Alg. 12): PM-estimated omega*, then JOR (Lemma 3)."""
    mu, kA, CA = npae_terms(log_theta, Xp, yp, Xs)
    return dec_npae_star_from_terms(mu, kA, CA, _prior_var(log_theta), A,
                                    jor_iters, dac_iters, pm_iters, jitter)


# ---------------------------------------------------------------------------
# CBNN nearest-neighbor family
# ---------------------------------------------------------------------------

def _nn(dec_fn):
    def method(log_theta, Xp, yp, Xs, A, eta_nn, iters=200):
        mask, _ = cbnn_mask(log_theta, Xp, Xs, eta_nn)
        m, v, info = dec_fn(log_theta, Xp, yp, Xs, A, iters, mask=mask)
        return m, v, {**info, "mask": mask}
    method.__name__ = f"dec_nn_{dec_fn.__name__[4:]}"
    method.__doc__ = (f"DEC-NN-{dec_fn.__name__[4:]}: CBNN mask (eq. 39), "
                      f"then {dec_fn.__name__} on the selected agents.")
    return method


dec_nn_poe = _nn(dec_poe)          # Alg. 13
dec_nn_gpoe = _nn(dec_gpoe)        # Alg. 14
dec_nn_bcm = _nn(dec_bcm)          # Alg. 15
dec_nn_rbcm = _nn(dec_rbcm)        # Alg. 16


def dec_nn_grbcm(log_theta, Xp_aug, yp_aug, Xc, yc, Xs, A, eta_nn,
                 iters=200, Xp=None):
    """DEC-NN-grBCM (Alg. 17). CBNN scores use the *local* datasets (eq. 39
    is defined on D_i), participation applies to the augmented experts."""
    Xp_scores = Xp if Xp is not None else Xp_aug
    mask, _ = cbnn_mask(log_theta, Xp_scores, Xs, eta_nn)
    m, v, info = dec_grbcm(log_theta, Xp_aug, yp_aug, Xc, yc, Xs, A, iters,
                           mask=mask)
    return m, v, {**info, "mask": mask}


def dec_nn_npae_from_terms(mask, mu, kA, CA, prior_var, A, dale_iters=2000,
                           jitter=1e-6, readout=None):
    """DEC-NN-NPAE (Alg. 18) core: CBNN-masked NPAE system solved by DALE —
    strongly connected suffices.

    Masked agents are decoupled (unit diagonal rows in H, zero b), so DALE
    solves the selected block exactly; the prediction is assembled from
    the agents' converged solution copies, averaged.

    `readout` (M,) 0/1 restricts which agents' copies are averaged (the
    degraded-mode hook: on a partitioned graph only the surviving
    component's copies converge). Default None averages every copy."""
    mk = mask.to(mu.dtype)
    H = _rel_jitter(_masked_system(CA, mk.T), jitter)
    kA_m = (kA * mk).T                                     # (Nt, M)
    mu_m = (mu * mk).T
    Q, res = dale(H, torch.stack([mu_m, kA_m], -1), A, dale_iters)
    # Q (Nt, agent, entry, 2): every agent holds the full solution
    if readout is None:
        q = Q.mean(1)
    else:
        r = readout.to(mu.dtype)
        q = torch.einsum("a,taek->tek", r, Q) / torch.clamp(r.sum(), min=1.0)
    mean, kck = (kA_m[..., None] * q).sum(1).unbind(-1)
    var = torch.clamp(prior_var - kck, min=1e-12)
    return mean, var, {"dale_residual": res[:, -1].max(), "mask": mask}


def dec_nn_npae(log_theta, Xp, yp, Xs, A, eta_nn, dale_iters=2000,
                jitter=1e-6):
    """DEC-NN-NPAE (Alg. 18): CBNN + DALE on a strongly connected graph."""
    mask, _ = cbnn_mask(log_theta, Xp, Xs, eta_nn)
    mu, kA, CA = npae_terms(log_theta, Xp, yp, Xs)
    return dec_nn_npae_from_terms(mask, mu, kA, CA, _prior_var(log_theta), A,
                                  dale_iters, jitter)
