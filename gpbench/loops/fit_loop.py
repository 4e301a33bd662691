"""Back-to-back hyperparameter refits: `GPFleet.fit(train=True)` of
`iters_per_fit` DEC-apx-GP iterations (eq. 34) from theta0, each building
its own training cache as a user's refit does. The window ends with the
last fit that began within `--seconds`.

End-to-end (host clock): admm_iter_ms, the window's milliseconds over the
iterations of its fits.

`correct`: every fit's trained log-thetas (every agent) and its first
residual (the agents' largest disagreement after the first iteration)
against the float64 reference's DEC-apx-GP from the same theta0 on the
same data; no fit failed.
"""
from __future__ import annotations

import math
import sys
import time

import torch

from gpbench import compare, data, program
from gpbench.reference import gp as ref
from gpbench.trace import Timed, label


class State:
    pass


def jitter_rel(cfg) -> float:
    """The training factorization's jitter, relative to sigma_f^2 +
    sigma_eps^2 and floored at 8 ulps of the configuration's dtype."""
    eps = torch.finfo(getattr(torch, cfg["dtype"])).eps
    return max(cfg["jitter"], 8 * eps)


def setup(run):
    cfg, tr = run.cfg, run.traffic
    dev = torch.device(run.device)
    st = State()
    st.Xp, st.yp, _, _ = data.fleet_data(cfg, run.seed, dev)
    run.mark("data")
    # one iteration through the same fleet warms every shape of a fit
    st.fleet = program.fleet(cfg, dev, admm_iters=1)
    st.fleet.fit(st.Xp, st.yp, train=True)
    run.mark("warm_fit")
    st.fleet.config = program.fleet_config(cfg,
                                           admm_iters=tr["iters_per_fit"])
    if run.device != "cpu":
        torch.cuda.synchronize()
    return st


def window(run, st):
    tr = run.traffic
    timed = Timed(run, tr["trace_after_s"], tr["trace_seconds"])
    st.fits = []
    run.mark_setup_done()
    t0 = time.perf_counter()
    while (elapsed := time.perf_counter() - t0) < run.seconds:
        timed.poll(elapsed)
        run.attempted += 1
        try:
            with label("fit"):
                st.fleet.fit(st.Xp, st.yp, train=True)
            st.fits.append((st.fleet.thetas.detach().clone(),
                            st.fleet.train_info["residuals"].detach()
                            .clone()))
            if run.device != "cpu":
                torch.cuda.synchronize()
        except (RuntimeError, ValueError, MemoryError) as e:
            print(f"gpbench: fit failed: {e!r}", file=sys.stderr)
            run.failed += 1
    elapsed = time.perf_counter() - t0
    timed.close()
    iters = len(st.fits) * tr["iters_per_fit"]
    run.e2e["admm_iter_ms"] = 1e3 * elapsed / iters if iters else math.inf
    M, N, D = st.Xp.shape
    run.layer.update(iters=iters, window_s=elapsed, shape=(M, N, D))
    if run.trace:
        run.layer["trace"] = timed.summary(ops=(
            "aten::linalg_cholesky_ex", "aten::linalg_solve_triangular",
            "aten::matmul"))


def release(run, st):
    del st.fleet


def reference_fit(run, Xp, yp, prec, A=None):
    cfg, tr = run.cfg, run.traffic
    dt = ref.dtype_of(prec)
    lt0 = torch.log(torch.tensor(cfg["theta0"], dtype=dt, device=Xp.device))
    return ref.dec_apx(Xp.to(dt), yp.to(dt), lt0,
                       data.graph(cfg) if A is None else A,
                       cfg["rho"], cfg["kappa"], tr["iters_per_fit"],
                       jitter_rel(cfg), prec)


def readings(run, fits, theta_ref, res_ref):
    lt0 = torch.log(torch.tensor(run.cfg["theta0"], dtype=torch.float64))
    return [compare.theta_gaps(th, res, theta_ref, res_ref, lt0)
            for th, res in fits]


def check(run, st):
    run.check("failed_fits", run.failed)
    theta_ref, res_ref = reference_fit(run, st.Xp, st.yp, "float64")
    gaps = readings(run, st.fits, theta_ref, res_ref)
    for key in ("theta_gap", "change_gap", "first_residual_gap"):
        run.check(key, compare.worst(gaps, key))
