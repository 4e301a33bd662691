#!/usr/bin/env python3
"""Smoke test of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, one JSON line each:

  build    nvcc-builds every CUDA source of the port (src/repro_torch/
           kernels/csrc/*.cu, all at once) for sm_90a.
  kernels  holds each kernel to its plain PyTorch version on the card, at
           the serving shapes and at ragged/edge shapes, and times the
           kernel, the plain version and a composed library yardstick with
           CUDA events beside the kernel's lower bound.
  serve    the main path: a paper-scale DEC-rBCM fleet (32,400 points from
           a GP field, M = 4 agents on a path graph, 200 DAC sweeps, chunk
           256, float32, streamed mean) fitted at the true hyperparameters
           through GPFleet, serving 8 micro-batches of 256 queries and one
           4,096-query call. It checks the kernel launched once per query
           tile, that the means agree with the same experts served without
           the kernel, and the RMSE against the noise-free field.

With --profile it then traces one 256-query batch of the main path with
torch.profiler and prints device time by kernel and the device's busy
share.

Then it prints the kernel table as one JSON object, the card's name and
power limit as nvidia-smi reports them, and last
{"ok": true, "device": {...}}. It exits non-zero, before printing any
result, without a CUDA device or without the port's sources beside it,
and non-zero after any failed phase.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# H100 SXM figures for the lower bounds (bound_ms):
HBM_BYTES_PER_S = 3.35e12       # NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12        # NVIDIA data sheet, outside the tensor cores
# exp2 on the special-function units: 16 results per clock per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0) at the 1,980 MHz maximum SM clock
SFU_EXP_PER_CLOCK_PER_SM = 16
SM_CLOCK_HZ = 1.98e9

TRUE_THETA = ([1.2, 0.3], 1.3, 0.1)   # paper §6: (l1, l2, sigma_f, sigma_eps)
N_TRAIN = 32_400                      # paper §6 (configs/paper_gp.py)
BATCH, N_BATCHES, BIG = 256, 8, 4096
REL_TOL = 1e-5                        # relative to sum_j |k_ij v_j|
RMSE_LIMIT = 0.2                      # twice sigma_eps


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of `fn` over `reps` back-to-back calls,
    by CUDA events, after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rbf_matvec_bound_ms(Nt: int, M: int, Ni: int, D: int,
                        sm_count: int) -> tuple[float, str]:
    """Least time for out (M, Nt) = sf2 * exp(-d2) @ v on the card: each
    input read once and the output written once over the memory rate, or
    the operations over their peak rates — per (query, point) pair one
    exp2 on the SFUs and 3D + 3 FP32 flops (D subtracts, D fused
    multiply-adds, the log2(e) scale, the accumulating fused multiply-add),
    whichever is larger."""
    pairs = Nt * M * Ni
    bytes_ = 4 * (Nt * D + M * Ni * D + M * Ni + 1 + M * Nt)
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_flops = pairs * (3 * D + 3) / FP32_FLOPS_PER_S
    t_exp = pairs / (SFU_EXP_PER_CLOCK_PER_SM * sm_count * SM_CLOCK_HZ)
    t_ops = max(t_flops, t_exp)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                        else "operations")


def phase_build(ctx):
    from repro_torch.kernels import _build
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    fresh = [n for n in names if not _build.library_path(n).exists()]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        libs = list(ex.map(_build.build, names))
    return {"seconds": time.perf_counter() - t0, "built": fresh,
            "libraries": [str(p) for p in libs]}


def _rel_err(torch, got, want, scale):
    return float(((got.double() - want.double()).abs()
                  / scale.double().clamp_min(1e-30)).max())


def phase_kernels(ctx):
    import torch
    from repro_torch.kernels import rbf_matvec as K
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(dev).manual_seed(ctx["seed"] + 1)
    # (Nt, M, Ni, D): the serving tile first, then ragged and edge shapes
    shapes = [(256, 4, 8100, 2), (200, 4, 8100, 2), (131, 4, 8099, 2),
              (256, 4, 1013, 1), (97, 3, 777, 3), (256, 2, 555, 8),
              (256, 40, 810, 2)]
    cases = []
    for Nt, M, Ni, D in shapes:
        ls = (torch.tensor(TRUE_THETA[0], device=dev) if D == 2
              else torch.full((D,), 0.5, device=dev))
        a = (2 * torch.rand(Nt, D, generator=gen, device=dev) / ls)
        b = (2 * torch.rand(M, Ni, D, generator=gen, device=dev) / ls)
        v = torch.randn(M, Ni, generator=gen, device=dev)
        sf2 = torch.tensor([TRUE_THETA[1] ** 2], device=dev)
        got = K.rbf_matvec(a, b, v, sf2)
        want = K.rbf_matvec_plain(a, b, v, sf2)
        scale = K.rbf_matvec_plain(a, b, v.abs(), sf2)
        torch.cuda.synchronize()
        case = {"Nt": Nt, "M": M, "Ni": Ni, "D": D,
                "max_rel_err": _rel_err(torch, got, want, scale),
                "max_abs_err": float((got - want).abs().max())}
        if not case["max_rel_err"] <= REL_TOL:
            raise AssertionError(f"rbf_matvec disagrees with its plain "
                                 f"version at {case}")
        if (Nt, M, Ni, D) == shapes[0]:
            # library yardstick: no single PyTorch call computes this
            # function, so the composition cdist -> exp -> bmm is timed
            def composed():
                k = torch.cdist(a[None].expand(M, Nt, D), b).square_()
                return sf2 * torch.bmm(k.neg_().exp_(), v[..., None])
            case["ms"] = cuda_ms(lambda: K.rbf_matvec(a, b, v, sf2), 200)
            case["plain_ms"] = cuda_ms(
                lambda: K.rbf_matvec_plain(a, b, v, sf2), 20)
            case["composed_library_ms"] = cuda_ms(composed, 20)
            case["bound_ms"], case["bound_by"] = rbf_matvec_bound_ms(
                Nt, M, Ni, D, sms)
            ctx["rbf_matvec"] = case
        cases.append(case)
    return {"rel_tol": REL_TOL, "rbf_matvec": cases}


def phase_serve(ctx):
    import torch
    from repro_torch.core.gp import pack, stripe_partition
    from repro_torch.core.prediction import PredictionEngine
    from repro_torch.core.prediction.local import local_moments_cached
    from repro_torch.data import gp_sample_field, random_inputs
    from repro_torch.fleet import FleetConfig, GPFleet
    from repro_torch.kernels import rbf_matvec as K
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(ctx["seed"])
    lt = pack(*TRUE_THETA, dtype=torch.float32, device=dev)
    n_query = N_BATCHES * BATCH + BIG
    # training inputs and held-out queries come from ONE field draw (RFF
    # above 4,096 points), so the queries' noise-free values are known
    X = random_inputs(gen, N_TRAIN + n_query, dtype=torch.float32)
    f, y = gp_sample_field(gen, X, lt)
    Xp, yp = stripe_partition(X[:N_TRAIN], y[:N_TRAIN], 4)
    Xq, fq = X[N_TRAIN:], f[N_TRAIN:]
    cfg = FleetConfig(stream_mean=True)
    assert (cfg.num_agents, cfg.graph, cfg.dac_iters, cfg.chunk,
            cfg.method) == (4, "path", 200, 256, "rbcm"), cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    fleet = GPFleet(cfg, device="cuda").fit(Xp, yp, log_theta0=lt,
                                            train=False)
    torch.cuda.synchronize()
    fit_ms = 1e3 * (time.perf_counter() - t0)
    if not all(bool(torch.isfinite(t).all()) for t in fleet.fitted):
        raise AssertionError("non-finite Cholesky factors")
    fleet.predict(Xq[:BATCH])                       # warm-up
    torch.cuda.synchronize()

    # the main path: counts reset just before, read just after
    K.reset_launches()
    batch_ms, means, variances = [], [], []
    t_all = time.perf_counter()
    for i in range(N_BATCHES):
        t0 = time.perf_counter()
        m, v, _ = fleet.predict(Xq[i * BATCH:(i + 1) * BATCH])
        torch.cuda.synchronize()
        batch_ms.append(1e3 * (time.perf_counter() - t0))
        means.append(m)
        variances.append(v)
    t0 = time.perf_counter()
    m, v, info = fleet.predict(Xq[N_BATCHES * BATCH:])
    torch.cuda.synchronize()
    big_ms = 1e3 * (time.perf_counter() - t0)
    total_s = time.perf_counter() - t_all
    launches = K.launches
    peak = torch.cuda.max_memory_allocated(dev)
    means.append(m)
    variances.append(v)
    mean, var = torch.cat(means), torch.cat(variances)

    tiles = N_BATCHES * -(-BATCH // cfg.chunk) + -(-BIG // cfg.chunk)
    if launches != tiles:
        raise AssertionError(f"rbf_matvec launched {launches} times for "
                             f"{tiles} query tiles")
    if mean.shape != (n_query,) or not bool(torch.isfinite(mean).all()) \
            or not bool(torch.isfinite(var).all()) or \
            not bool((var > 0).all()):
        raise AssertionError("served moments are not finite and positive "
                             "of the expected shape")
    rmse = float(torch.sqrt(((mean - fq) ** 2).mean()))
    if not rmse < RMSE_LIMIT:
        raise AssertionError(f"RMSE {rmse} against the noise-free field "
                             f"is not below {RMSE_LIMIT}")

    # the same experts served without the kernel (dense mean k^T alpha);
    # a per-agent mean error e_i reaches the rBCM mean as sum_i w_i e_i
    # with w_i = (beta_i / var_i) / prec, so the per-query scale is
    # sum_i |w_i| sum_j |k_ij alpha_ij|
    dense = PredictionEngine(fleet.fitted, fleet.A, chunk=cfg.chunk,
                             dac_iters=cfg.dac_iters, stream_mean=False,
                             device="cuda")
    ft = fleet.fitted
    ls, sf = torch.exp(ft.log_theta[:-2]), torch.exp(ft.log_theta[-2])
    sf2 = (sf ** 2).reshape(1)
    agent_err = mean_err = 0.0
    for t0_ in range(0, n_query, cfg.chunk):
        Xt = Xq[t0_:t0_ + cfg.chunk]
        mu_d, var_d = local_moments_cached(ft.log_theta, ft.Xp, ft.L,
                                           ft.alpha, Xt)
        mu_s = fleet.engine.posterior_means_streamed(Xt)
        S = K.rbf_matvec_plain(Xt / ls, ft.Xp / ls, ft.alpha.abs(), sf2)
        agent_err = max(agent_err, _rel_err(torch, mu_s, mu_d, S))
        beta = 0.5 * (torch.log(sf2) - torch.log(var_d))
        prec = (beta / var_d).sum(0) + (1 - beta.sum(0)) / sf2
        scale = ((beta / var_d / prec).abs() * S).sum(0)
        m_d = dense.predict("rbcm", Xt)[0]
        mean_err = max(mean_err, _rel_err(
            torch, mean[t0_:t0_ + cfg.chunk], m_d, scale))
    if not (agent_err <= REL_TOL and mean_err <= REL_TOL):
        raise AssertionError(f"streamed vs dense means: per-agent "
                             f"{agent_err}, rBCM {mean_err} > {REL_TOL}")
    ctx["launches"] = {"rbf_matvec": launches}
    ctx["fleet"], ctx["queries"] = fleet, Xq
    return {"n_train": N_TRAIN, "agents": cfg.num_agents,
            "per_agent": int(Xp.shape[1]), "dac_iters": cfg.dac_iters,
            "chunk": cfg.chunk, "dtype": "float32", "queries": n_query,
            "fit_ms": fit_ms, "batch_ms": batch_ms,
            "mean_batch_ms": sum(batch_ms) / len(batch_ms),
            "big_call_ms": big_ms, "queries_per_s": n_query / total_s,
            "peak_memory_bytes": peak, "rbf_matvec_launches": launches,
            "query_tiles": tiles, "rmse_vs_field": rmse,
            "max_rel_err_agent_means": agent_err,
            "max_rel_err_rbcm_means": mean_err,
            "dac_residual_4096": float(info["dac_residual"])}


def phase_profile(ctx):
    """Device time by kernel over one served 256-query batch, and the
    device's busy share of the batch's wall time (one stream: kernels do
    not overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fleet, Xb = ctx["fleet"], ctx["queries"][:BATCH]
    fleet.predict(Xb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fleet.predict(Xb)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    if not by_kernel:
        raise RuntimeError("the profiler recorded no device activity")
    busy_us = sum(us for us, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    port = [(us, n) for k, (us, n) in by_kernel.items() if "rbf_matvec" in k]
    return {"batch": BATCH, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3,
            "rbf_matvec_device_ms": sum(us for us, _ in port) / 1e3,
            "rbf_matvec_device_launches": sum(n for _, n in port),
            "device_idle_share": 1.0 - busy_us / wall_us,
            "kernels_launched": sum(n for _, n in by_kernel.values()),
            "top_kernels": [{"name": k[:120], "ms": us / 1e3, "count": n}
                            for k, (us, n) in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one served batch with torch.profiler")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's sources are missing ({e})",
              file=sys.stderr)
        return 1

    card = card_line()
    ctx = {"seed": args.seed}
    failed = []
    phases = [("build", phase_build), ("kernels", phase_kernels),
              ("serve", phase_serve)]
    if args.profile:
        phases.append(("profile", phase_profile))
    for name, fn in phases:
        try:
            out = fn(ctx)
            emit({"phase": name, "ok": True, "card": card, **out})
        except Exception as e:  # report every phase, fail at the end
            traceback.print_exc()
            failed.append(name)
            emit({"phase": name, "ok": False, "card": card,
                  "error": f"{type(e).__name__}: {e}"})
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    k = ctx["rbf_matvec"]
    emit({"kernels": [{
        "name": "rbf_matvec", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rbf_matvec.cu",
        "replaces": "src/repro/kernels/rbf_matvec.py:46",
        "launches": ctx["launches"]["rbf_matvec"],
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
