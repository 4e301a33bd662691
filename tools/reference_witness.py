#!/usr/bin/env python3
"""The reference (src/repro, JAX) beside the port (src/repro_torch) on the
CPU, in float64, on the same data, at per-agent sizes below the paper
fleet's 8,100: two findings of chip_smoke.py's methods phase, each held
against the reference where it can run.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/reference_witness.py \\
        [--per-agent 500,1000,2000] [--seed 0]
        [--parts c8,gapx,npae,nn_npae,fullgp,c11,scenario]

  c8    DEC-NPAE* (npae_star) on a 4-agent path fleet of one draw of the
        paper's field (true theta, 256 held-out queries): RMSE against
        the noise-free field and the final JOR residual at FleetConfig's
        500 JOR iterations and at chip_smoke.py's NPAE_STAR_JOR_ITERS,
        with npae (500) and cen_npae beside, from both packages.
  gapx  gapx and dec-gapx, 3 iterations from FleetConfig's theta0 on the
        augmented data D_{+i} (2 N_i points per agent, the communication
        set drawn by the port and fed to both), with kappa = L scaled from
        chip_smoke.py's GAPX_KAPPA at 16,200 points by 2 N_i / 16,200, and
        rho both at FleetConfig's 500 and scaled the same way (with rho,
        kappa and the NLL's gradient all in proportion to N, the ADMM
        step is the same at every N): sigma_eps per agent and the
        residuals from both packages.

  npae  npae at FleetConfig's 500 JOR and 200 DAC iterations (JOR's
        omega = 2/M) with cen_npae beside, on the c8 fleet: RMSE against
        the noise-free field and the final JOR and DAC residuals, from
        both packages (C9).
  nn_npae  nn_npae at FleetConfig's 2,000 DALE iterations and eta_NN =
        0.1 with cen_npae beside: RMSE, the final DALE residual and the
        agents CBNN selects per query, from both packages (C9).
  fullgp  predict_full over all 4 N_i points of the c8 field at the true
        theta in float32 and in float64, from both packages: whether
        the moments are finite (a float32 Cholesky that fails gives NaN
        in both) and their RMSE against the noise-free field.
  c11   rbcm on the c8 fleet in float32, 200 DAC sweeps, without a fault
        plan and under FaultPlan(dropouts=(Dropout(0),)), with the
        residual guard off (degraded_tol = inf), from both packages: the
        final DAC residual each reports, beside the payload scale (the
        largest sum over the agents of |beta_i / var_i|, which DAC's
        float32 rounding floor is proportional to). The residual that
        the reference's absolute degraded_tol = 1e-2 is held against.
        The reference runs with jax_enable_x64 off, as JAX runs by
        default: with it on, its degraded DAC fails to trace in float32.
  scenario  the reference test's tiny chaos mission (tests/test_scenario.py
        `_TINY` + `_CHAOS`) on the cycle and the complete graph: the
        reference's run_scenario on its jax.random world and the port's
        run_scenario (float64, CPU) on its host-drawn world, with the
        reference's accuracy invariants for each: final RMSE below 0.8 of
        the first, final NLL below the first, drift-epoch NLL monotone
        within 0.25; after the last seed a summary line counts the seeds
        that meet them. --per-agent does not apply; --seed takes a list.

Each (part, size, seed) prints one JSON line. The paper fleet itself is not run
here: the reference's NPAE terms hold 16 Gram blocks of 8,100^2 points at
once (8.4 GB in float64) beside the factors, and its gapx 4 kernel
matrices of 16,200^2 with their autodiff transients; the card's machine
has no JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TRUE_THETA = ([1.2, 0.3], 1.3, 0.1)
N_QUERIES = 256
JOR_COUNTS = (500, 50_000)          # FleetConfig's, NPAE_STAR_JOR_ITERS
GAPX_KAPPA, GAPX_POINTS, GAPX_ITERS = 20_000.0, 16_200, 3
SCENARIO_TINY = dict(num_agents=4, method="gpoe", steps=9, warmup_obs=5,
                     window=14, dac_iters=40, admm_iters=4, drift_every=3,
                     drift_iters=3, eval_points=24, field_features=96,
                     queries_per_step=1, query_rows=3, max_slot=8, chunk=8,
                     dropouts=((1, 2, 6),), straggle_every=3,
                     straggle_ms=1.0, fail_every=5, edge_loss=0.05)


def paper_field(per_agent: int, seed: int):
    """Stripes of one draw of the paper's field (as chip_smoke.py's
    paper_data, on the CPU in float64) and noise-free held-out queries:
    numpy (Xp (4, Ni, 2), yp (4, Ni), Xq (256, 2), fq (256,))."""
    import torch
    from repro_torch.core.gp import pack, stripe_partition
    from repro_torch.data import random_inputs, rff_field
    gen = torch.Generator().manual_seed(seed)
    lt = pack(*TRUE_THETA)
    n = 4 * per_agent
    X = random_inputs(gen, n + N_QUERIES)
    f = rff_field(gen, lt, 2)(X)
    y = f + math.exp(float(lt[-1])) * torch.randn(n + N_QUERIES,
                                                  generator=gen,
                                                  dtype=torch.float64)
    Xp, yp = stripe_partition(X[:n], y[:n], 4)
    return Xp.numpy(), yp.numpy(), X[n:].numpy(), f[n:].numpy()


def c8(per_agent: int, seed: int) -> dict:
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.core.consensus import path_graph as jpath_graph
    from repro.core.prediction import PredictionEngine as JEngine
    from repro.core.prediction import fit_experts as jfit_experts
    from repro_torch.core.consensus import path_graph
    from repro_torch.core.gp import pack
    from repro_torch.core.prediction import PredictionEngine, fit_experts
    Xp, yp, Xq, fq = paper_field(per_agent, seed)
    lt = pack(*TRUE_THETA)
    jfit = jfit_experts(jnp.asarray(lt.numpy()), jnp.asarray(Xp),
                        jnp.asarray(yp))
    tfit = fit_experts(lt, torch.from_numpy(Xp), torch.from_numpy(yp))
    out = {"part": "c8", "per_agent": per_agent, "seed": seed}
    for pkg in ("reference", "port"):
        res = {}
        for method, iters in (("npae", 500), ("cen_npae", 500),
                              *(("npae_star", it) for it in JOR_COUNTS)):
            if pkg == "reference":
                e = JEngine(jfit, jpath_graph(4), jor_iters=iters)
                m, _, info = e.predict(method, jnp.asarray(Xq))
            else:
                e = PredictionEngine(tfit, path_graph(4), jor_iters=iters,
                                     device="cpu")
                m, _, info = e.predict(method, torch.from_numpy(Xq))
            r = {"rmse": float(np.sqrt(np.mean((np.asarray(m) - fq) ** 2)))}
            if "jor_residual" in info:
                r["jor_residual"] = float(info["jor_residual"])
            res[f"{method}@{iters}" if method == "npae_star" else method] = r
        out[pkg] = res
    return out


def _npae_family(part: str, methods, per_agent: int, seed: int) -> dict:
    """Serve `methods` ((name, engine keywords) pairs) from both packages
    on the c8 fleet at the true theta: RMSE against the noise-free field,
    every final residual the engine reports, and the mean count of agents
    CBNN selects per query where there is a mask."""
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.core.consensus import path_graph as jpath_graph
    from repro.core.prediction import PredictionEngine as JEngine
    from repro.core.prediction import fit_experts as jfit_experts
    from repro_torch.core.consensus import path_graph
    from repro_torch.core.gp import pack
    from repro_torch.core.prediction import PredictionEngine, fit_experts
    Xp, yp, Xq, fq = paper_field(per_agent, seed)
    lt = pack(*TRUE_THETA)
    jfit = jfit_experts(jnp.asarray(lt.numpy()), jnp.asarray(Xp),
                        jnp.asarray(yp))
    tfit = fit_experts(lt, torch.from_numpy(Xp), torch.from_numpy(yp))
    out = {"part": part, "per_agent": per_agent, "seed": seed}
    for pkg in ("reference", "port"):
        res = {}
        for method, kw in methods:
            if pkg == "reference":
                e = JEngine(jfit, jpath_graph(4), **kw)
                m, _, info = e.predict(method, jnp.asarray(Xq))
            else:
                e = PredictionEngine(tfit, path_graph(4), device="cpu", **kw)
                m, _, info = e.predict(method, torch.from_numpy(Xq))
            r = {"rmse": float(np.sqrt(np.mean((np.asarray(m) - fq) ** 2)))}
            for k in ("jor_residual", "dac_residual", "dale_residual"):
                if k in info:
                    r[k] = float(info[k])
            if "mask" in info:
                r["agents_per_query"] = float(
                    np.asarray(info["mask"]).sum(0).mean())
            res[method] = r
        out[pkg] = res
    return out


def npae(per_agent: int, seed: int) -> dict:
    return _npae_family("npae", (("npae", {"jor_iters": 500,
                                           "dac_iters": 200}),
                                 ("cen_npae", {})), per_agent, seed)


def nn_npae(per_agent: int, seed: int) -> dict:
    return _npae_family("nn_npae", (("nn_npae", {"dale_iters": 2_000,
                                                 "eta_nn": 0.1}),
                                    ("cen_npae", {})), per_agent, seed)


def fullgp(per_agent: int, seed: int) -> dict:
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.core.gp.exact import predict_full as j_predict_full
    from repro_torch.core.gp import pack, predict_full
    Xp, yp, Xq, fq = paper_field(per_agent, seed)
    X, y = Xp.reshape(-1, 2), yp.reshape(-1)
    lt = pack(*TRUE_THETA).numpy()
    out = {"part": "fullgp", "points": int(X.shape[0]), "seed": seed}
    for name in ("float32", "float64"):
        args = [a.astype(name) for a in (lt, X, y, Xq)]
        res = {}
        for pkg in ("reference", "port"):
            if pkg == "reference":
                m, v = j_predict_full(*(jnp.asarray(a) for a in args))
            else:
                m, v = predict_full(*(torch.from_numpy(a) for a in args))
            m, v = np.asarray(m, np.float64), np.asarray(v, np.float64)
            finite = bool(np.isfinite(m).all() and np.isfinite(v).all())
            res[pkg] = {"finite": finite, "rmse": float(
                np.sqrt(np.mean((m - fq) ** 2))) if finite else None}
        out[name] = res
    return out


def c11(per_agent: int, seed: int) -> dict:
    import jax
    jax.config.update("jax_enable_x64", False)
    try:
        return _c11(per_agent, seed)
    finally:
        jax.config.update("jax_enable_x64", True)


def _c11(per_agent: int, seed: int) -> dict:
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.chaos import Dropout as JDropout
    from repro.chaos import FaultPlan as JFaultPlan
    from repro.core.consensus import path_graph as jpath_graph
    from repro.core.prediction import PredictionEngine as JEngine
    from repro.core.prediction import fit_experts as jfit_experts
    from repro_torch.chaos import Dropout, FaultPlan
    from repro_torch.core.consensus import path_graph
    from repro_torch.core.gp import pack
    from repro_torch.core.prediction import PredictionEngine, fit_experts
    Xp, yp, Xq, _ = (a.astype(np.float32) for a in
                     paper_field(per_agent, seed))
    lt = pack(*TRUE_THETA, dtype=torch.float32)
    jfit = jfit_experts(jnp.asarray(lt.numpy()), jnp.asarray(Xp),
                        jnp.asarray(yp))
    tfit = fit_experts(lt, torch.from_numpy(Xp), torch.from_numpy(yp))
    kw = {"dac_iters": 200, "degraded_tol": math.inf}
    jeng = JEngine(jfit, jpath_graph(4), **kw)
    teng = PredictionEngine(tfit, path_graph(4), device="cpu", **kw)
    mu, var = teng._moments(tfit, torch.from_numpy(Xq))
    beta = 0.5 * (torch.log(tfit.prior_var) - torch.log(var))
    out = {"part": "c11", "per_agent": per_agent, "seed": seed,
           "dtype": "float32", "dac_iters": 200,
           "payload_scale": float((beta / var).abs().sum(0).max())}
    for pkg, run, plan in (
            ("reference", lambda p: jeng.predict("rbcm", jnp.asarray(Xq),
                                                 fault_plan=p),
             JFaultPlan(dropouts=(JDropout(0),))),
            ("port", lambda p: teng.predict("rbcm", torch.from_numpy(Xq),
                                            fault_plan=p),
             FaultPlan(dropouts=(Dropout(0),)))):
        out[pkg] = {"exact_dac_residual": float(run(None)[2]
                                                ["dac_residual"]),
                    "drop0_dac_residual": float(run(plan)[2]
                                                ["dac_residual"])}
    return out


def gapx(per_agent: int, seed: int) -> dict:
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.core.consensus import path_graph as jpath_graph
    from repro.core.training import train_dec_gapx_gp as j_dec_gapx
    from repro.core.training import train_gapx_gp as j_gapx
    from repro_torch.core.consensus import path_graph
    from repro_torch.core.gp import augment, communication_dataset
    from repro_torch.core.training import train_dec_gapx_gp, train_gapx_gp
    from repro_torch.fleet import FleetConfig
    Xp, yp, _, _ = paper_field(per_agent, seed)
    gen = torch.Generator().manual_seed(seed + 7)
    Xc, yc = communication_dataset(gen, torch.from_numpy(Xp),
                                   torch.from_numpy(yp))
    Xa, ya = (a.contiguous() for a in augment(torch.from_numpy(Xp),
                                              torch.from_numpy(yp), Xc, yc))
    n_aug = Xa.shape[1]
    scale = n_aug / GAPX_POINTS
    kappa = GAPX_KAPPA * scale
    th0 = FleetConfig().theta0
    lt0 = np.log(np.asarray(th0, dtype=np.float64))
    out = {"part": "gapx", "per_agent": per_agent, "augmented": n_aug,
           "seed": seed, "kappa": kappa, "iters": GAPX_ITERS}
    for rho_name, rho in (("rho_500", 500.0), ("rho_scaled", 500.0 * scale)):
        runs = {}
        for trainer in ("gapx", "dec-gapx"):
            if trainer == "gapx":
                _, tt, ti = train_gapx_gp(torch.from_numpy(lt0), Xa, ya,
                                          rho=rho, L=kappa, iters=GAPX_ITERS)
                _, jt, ji = j_gapx(jnp.asarray(lt0), jnp.asarray(Xa.numpy()),
                                   jnp.asarray(ya.numpy()), rho=rho, L=kappa,
                                   iters=GAPX_ITERS)
            else:
                tt, ti = train_dec_gapx_gp(torch.from_numpy(lt0), Xa, ya,
                                           path_graph(4), rho=rho,
                                           kappa=kappa, iters=GAPX_ITERS)
                jt, ji = j_dec_gapx(jnp.asarray(lt0), jnp.asarray(Xa.numpy()),
                                    jnp.asarray(ya.numpy()), jpath_graph(4),
                                    rho=rho, kappa=kappa, iters=GAPX_ITERS)
            runs[trainer] = {
                pkg: {"sigma_eps_per_agent": np.exp(np.asarray(t)[:, -1])
                      .tolist(),
                      "residuals": np.asarray(i["residuals"]).tolist()}
                for pkg, t, i in (("reference", jt, ji), ("port", tt, ti))}
        out[rho_name] = {"rho": rho, **runs}
    return out


def scenario(per_agent: int, seed: int) -> dict:
    import torch
    from repro.scenario import ScenarioConfig as JConfig
    from repro.scenario import run_scenario as j_run_scenario
    from repro_torch.scenario import ScenarioConfig, run_scenario
    out = {"part": "scenario", "seed": seed}
    for graph in ("cycle", "complete"):
        for pkg, cls, run in (
                ("reference", JConfig, j_run_scenario),
                ("port", ScenarioConfig,
                 lambda c: run_scenario(c, device="cpu",
                                        dtype=torch.float64))):
            r = run(cls(seed=seed, fault_seed=seed, graph=graph,
                        **SCENARIO_TINY))
            rmse, nll = r.curves["rmse"], r.curves["nll"]
            inv = {"rmse_ratio": rmse[-1] / rmse[0],
                   "rmse_below_0.8": rmse[-1] < 0.8 * rmse[0],
                   "nll_falls": nll[-1] < nll[0],
                   "drift_monotone": all(b <= a + 0.25 for a, b in zip(
                       r.drift_nll, r.drift_nll[1:]))}
            inv["all"] = inv["rmse_below_0.8"] and inv["nll_falls"] and \
                inv["drift_monotone"]
            out[f"{pkg}_{graph}"] = inv
    return out


def scenario_summary(missions) -> dict:
    """Per package and graph over the seeds run: the seeds meeting all
    three invariants, those meeting the RMSE one, and the median final/
    first RMSE ratio."""
    import statistics
    out = {"part": "scenario_summary",
           "seeds": [m["seed"] for m in missions]}
    for key in missions[0]:
        if key in ("part", "seed"):
            continue
        runs = [m[key] for m in missions]
        out[key] = {
            "all": sum(r["all"] for r in runs),
            "rmse_below_0.8": sum(r["rmse_below_0.8"] for r in runs),
            "median_rmse_ratio": statistics.median(r["rmse_ratio"]
                                                   for r in runs)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--per-agent", default="500,1000,2000")
    ap.add_argument("--seed", default="0")
    ap.add_argument("--parts", default="c8,gapx")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import torch
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(4)
    parts = {"c8": c8, "gapx": gapx, "npae": npae, "nn_npae": nn_npae,
             "fullgp": fullgp, "c11": c11, "scenario": scenario}
    sizes = [int(v) for v in args.per_agent.split(",")]
    missions = []
    for seed in (int(v) for v in args.seed.split(",")):
        for part in args.parts.split(","):
            for n in sizes[:1] if part == "scenario" else sizes:
                out = parts[part](n, seed)
                if part == "scenario":
                    missions.append(out)
                print(json.dumps(out), flush=True)
    if missions:
        print(json.dumps(scenario_summary(missions)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
