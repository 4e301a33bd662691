"""The numbers that decide `correct`, each computed from the program's
answers and the reference's on the same inputs."""
from __future__ import annotations

import numpy as np
import torch


def answer_errors(mean, var, mean_ref, var_ref, sigma_f: float) -> dict:
    """Served answers against the reference's:
      mean_err  max |mean - mean_ref| / sigma_f,
      var_err   max |var - var_ref| / sigma_f^2,
    both on the prior's scale: near the data the variance is a small
    difference of terms of order sigma_f^2, so its relative error in
    float32 is of order one."""
    m, v = (torch.as_tensor(np.asarray(a), dtype=torch.float64)
            for a in (mean, var))
    mr, vr = (torch.as_tensor(a).double().cpu() for a in (mean_ref, var_ref))
    return {"mean_err": float(((m - mr).abs() / sigma_f).max()),
            "var_err": float(((v - vr).abs() / sigma_f ** 2).max())}


def sums_scale(mean, var) -> float:
    """The largest network sum behind rBCM answers (mean, var): the sums
    are mean / var, about 1 / var, and the weights' sum, so max over the
    queries of max(|mean|, 1) / var."""
    m, v = (torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
            .double().cpu() for a in (mean, var))
    return float((torch.clamp(m.abs(), min=1.0) / v).max())


def dac_error(residual, mean, var, residual_ref, mean_ref, var_ref) -> float:
    """The agents' disagreement after the DAC sweeps (the consensus
    residual: the widest spread between their estimates, as the engine
    reports it) over the largest network sum they agree on, the program's
    against the reference's on the same queries, each side scaled by its
    own answers:
        | res / scale(mean, var) - res_ref / scale(mean_ref, var_ref) |.
    It reads the sweeps' round-off when the agents agree, and near 1 when
    they never exchanged (each agent then keeps its own payload, though the
    mean over the agents, and so the answer, is unchanged). Each side has
    its own scale because float32 local variances near dense data lose
    most of their digits to cancellation, and a payload beta / var with
    them, while the served answer stays within its limits."""
    r = float(residual)
    scale = sums_scale(mean, var)
    if not (np.isfinite(r) and np.isfinite(scale)) or scale <= 0:
        return float("inf")
    return abs(r / scale - residual_ref / sums_scale(mean_ref, var_ref))


def bad_answers(mean, var) -> int:
    """Answers that are not finite or have var <= 0."""
    m, v = np.asarray(mean), np.asarray(var)
    return int((~np.isfinite(m) | ~np.isfinite(v) | ~(v > 0)).sum())


def factor_error(L, L_ref) -> float:
    """max over agents of max |L - L_ref| / max |L_ref|."""
    worst = 0.0
    for a, b in zip(L, L_ref):
        b = b.double()
        err = float((a.double() - b).abs().max() / b.abs().max())
        worst = max(worst, err if np.isfinite(err) else float("inf"))
    return worst


def theta_gaps(thetas, residuals, theta_ref, res_ref, theta0) -> dict:
    """A fit's trained log-thetas (M, K) and residual series against the
    reference's:
      theta_gap           max |log theta - log theta_ref|,
      change_gap          worst agent's | ||theta - theta0|| -
                          ||theta_ref - theta0|| | / ||theta_ref - theta0||
                          (a fit that leaves theta unchanged reads 1),
      first_residual_gap  |res_1 - res_ref_1| / max res_ref: the agents'
                          disagreement after the first iteration, where
                          each agent's step is its own gradient over the
                          graph's penalties, from theta0 (C well
                          conditioned). Later iterations are not compared:
                          once sigma_eps has shrunk the float32 gradient's
                          rounding moves their residuals as far as an
                          exchange left out does."""
    th, tr = thetas.double().cpu(), theta_ref.double().cpu()
    t0 = theta0.double().cpu()
    n, nr = (th - t0).norm(dim=1), (tr - t0).norm(dim=1)
    r, rr = residuals.double().cpu(), res_ref.double().cpu()
    return {"theta_gap": float((th - tr).abs().max()),
            "change_gap": float(((n - nr).abs() / nr).max()),
            "first_residual_gap": float((r[0] - rr[0]).abs()
                                        / rr.abs().max())}


def worst(readings: list[dict], key: str) -> float:
    vals = [r[key] for r in readings]
    if any(not np.isfinite(v) for v in vals):
        return float("inf")
    return max(vals) if vals else float("inf")
