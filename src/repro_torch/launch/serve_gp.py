"""GP serving launcher — a thin CLI overlay on `repro_torch.fleet.GPFleet`.

Counterpart of the default replicated mode of `repro.launch.serve_gp`:
build synthetic fleet data (a GP field sampled at random inputs, stripe-
partitioned over the agents), cache the factors at the true
hyperparameters — or, with `--train-iters N`, train them first with
`--trainer` (ADMM started at the true theta, as the reference does) —
coalesce ragged requests into fixed-size micro-batches, serve them through
`GPFleet.predict` and print the rate.

  PYTHONPATH=src python -m repro_torch.launch.serve_gp --agents 8 \
      --per-agent 128 --method rbcm --requests 64 --batch 256 --chunk 128
  PYTHONPATH=src python -m repro_torch.launch.serve_gp --device cpu \
      --trainer dec-apx --train-iters 5 --agents 4 --per-agent 64
  PYTHONPATH=src python -m repro_torch.launch.serve_gp --device cpu \
      --online --observe-every 4 --agents 4 --per-agent 64
  PYTHONPATH=src python -m repro_torch.launch.serve_gp --device cpu \
      --sparse-m 32 --method npae-sparse --agents 4 --per-agent 256
  PYTHONPATH=src python -m repro_torch.launch.serve_gp --device cpu \
      --method nn-npae --agents 4 --per-agent 64 --eta-nn 0.5
  PYTHONPATH=src python -m repro_torch.launch.serve_gp --device cpu \
      --method grbcm --trainer dec-gapx --train-iters 5 --agents 4 \
      --per-agent 64

Every method of the fleet registry serves under `--method` (hyphens or
underscores), and every centralized reference as `cen_<method>`; the
grbcm methods and the gapx/dec-gapx trainers draw the grBCM communication
dataset from the launcher's generator.

`--online` is the streaming front door (the reference's serve_online):
the fleet keeps one sliding window per agent (FleetConfig(online=True)),
and between prediction micro-batches every agent ingests
`--observe-every` fresh observations through `GPFleet.observe` (rank-1
factor updates on the hand-written cholupdate kernel, swapped into the
engine in place). It prints q/s and obs/s and checks that the engine and
its adjacency survived the stream and serve the streamed factors.

`--sparse-m M` fits sparse pseudo-representation experts with M inducing
points per agent (FleetConfig(sparse_m=M), the Kmn statistics on the
hand-written rbf_gram kernel) instead of the dense factors; it is what the
sparse trainers and the method npae-sparse need.

It runs on the card unless `--device cpu` is given, with the streamed
mean (the hand-written rbf_matvec kernel) unless `--no-stream`, on
float32 data unless `--dtype float64` is given, as the reference runs in
float32 unless x64 is enabled. A sparse fleet with a few hundred inducing
points per agent needs float64: there the inducing points' Gram matrix is
singular to float32 and the sparse fit's Cholesky fails, in the reference
as here. The kernels compute in float32 either way.

  PYTHONPATH=src python -m repro_torch.launch.serve_gp --sparse-m 512 \
      --method npae-sparse --agents 4 --per-agent 8100 --dtype float64

Fitted-fleet persistence and metrics, in the reference's formats:

  --save-fleet DIR        after fitting, `GPFleet.save` the factors +
                          config + consensus graph to DIR
  --from-checkpoint DIR   skip building and fitting: `GPFleet.load` DIR
                          (saved by either package) and serve it
  --metrics-dump PATH     at exit, write the Prometheus text dump of the
                          `obs` default registry to PATH

  PYTHONPATH=src python -m repro_torch.launch.serve_gp --device cpu \
      --agents 4 --per-agent 64 --requests 2 --save-fleet /tmp/fleet
  PYTHONPATH=src python -m repro_torch.launch.serve_gp --device cpu \
      --requests 4 --from-checkpoint /tmp/fleet --metrics-dump /tmp/m.txt
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.gp import pack, stripe_partition
from ..data import gp_sample_field, random_inputs
from ..device import resolve_device
from ..fleet import (FleetConfig, GPFleet, method_names, trainer_names,
                     validate_config)
from ..obs import prometheus_text

_TRUE_THETA = ([1.2, 0.3], 1.3, 0.1)


def build_data(generator: torch.Generator, M: int, per_agent: int,
               dtype=torch.float32):
    """Synthetic fleet data: sample a GP field, stripe-partition."""
    lt_true = pack(*_TRUE_THETA, dtype=dtype, device=generator.device)
    X = random_inputs(generator, M * per_agent, dtype=dtype)
    _, y = gp_sample_field(generator, X, lt_true)
    return stripe_partition(X, y, M)


def request_stream(generator: torch.Generator, n_requests: int,
                   max_size: int, dtype=torch.float32):
    """Ragged prediction requests (what a front door actually receives)."""
    sizes = np.random.default_rng(0).integers(1, max_size + 1,
                                              size=n_requests)
    return [random_inputs(generator, int(s), dtype=dtype) for s in sizes]


def micro_batches(requests, batch: int):
    """Concatenate ragged requests and cut into fixed-size micro-batches
    (tail zero-padded). Returns (batches (n, batch, D), total_queries,
    slices per request)."""
    sizes = [int(r.shape[0]) for r in requests]
    allq = torch.cat(requests)
    total = allq.shape[0]
    pad = (-total) % batch
    allq = torch.cat([allq, allq.new_zeros(pad, allq.shape[1])])
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + s)
    slices = list(zip(offs[:-1], offs[1:]))
    return allq.reshape(-1, batch, allq.shape[1]), total, slices


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_online(args, fleet: GPFleet, method: str, batches, total: int,
                 generator: torch.Generator) -> None:
    """Interleaved observe/predict loop: the live-fleet serving front door.

    Observation events ride `GPFleet.observe` (O(W^2) rank-1 updates);
    prediction micro-batches ride the engine, whose served factors are
    swapped in place (`swap_experts`): the engine object, its adjacency
    and its hyperparameters stay the same tensors (asserted at exit)."""
    M, device = fleet.num_agents, fleet.device
    dtype = fleet.fitted.Xp.dtype

    def fresh():
        xs = random_inputs(generator, M, dtype=dtype)
        return xs, torch.randn(M, generator=generator, dtype=dtype,
                               device=device)

    # warm-up builds what the stream reuses (the kernels' libraries); the
    # ingest is rolled back so serving starts from the fitted windows
    state0, fitted0 = fleet._online_state, fleet.fitted
    fleet.observe(*fresh())
    fleet._online_state, fleet.fitted = state0, fitted0
    fleet.predict(batches[0], method=method)
    _sync(device)
    engine = fleet.engine
    kept = (engine.A.data_ptr(), engine.fitted.log_theta.data_ptr())
    served0 = engine.fitted.L

    n_obs = 0
    t0 = time.perf_counter()
    for b in batches:
        for _ in range(args.observe_every):
            fleet.observe(*fresh())
            n_obs += M
        fleet.predict(b, method=method)
    _sync(device)
    dt = time.perf_counter() - t0
    if fleet.engine is not engine or kept != (
            engine.A.data_ptr(), engine.fitted.log_theta.data_ptr()):
        raise AssertionError("the stream rebuilt the engine or its "
                             "adjacency instead of swapping the factors")
    if engine.fitted.L is not fleet.fitted.L or \
            (n_obs and engine.fitted.L is served0):
        raise AssertionError("the engine does not serve the streamed "
                             "factors")
    W = fleet.fitted.Xp.shape[1]
    print(f"online {method}: served {total} queries + ingested {n_obs} "
          f"observations in {dt * 1e3:.1f} ms ({total / dt:.0f} q/s, "
          f"{n_obs / dt:.0f} obs/s, window={W}; engine and adjacency "
          f"kept, factors swapped in place)")


def main(argv=None):
    methods = sorted(method_names())
    cen = [f"cen_{m}" for m in methods]
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=8)
    ap.add_argument("--per-agent", type=int, default=256)
    ap.add_argument("--method", default=None,
                    type=lambda s: s.replace("-", "_"),
                    choices=methods + cen,
                    help="prediction method (default: rbcm, or the saved "
                         "config's with --from-checkpoint)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=256,
                    help="micro-batch size")
    ap.add_argument("--chunk", type=int, default=128,
                    help="engine query-tile size")
    ap.add_argument("--dac-iters", type=int, default=100)
    ap.add_argument("--trainer", default="dec-apx",
                    choices=sorted(trainer_names()),
                    help="training loop (fleet registry name)")
    ap.add_argument("--train-iters", type=int, default=0,
                    help="training rounds (0 = use the true "
                         "hyperparameters)")
    ap.add_argument("--no-stream", action="store_true",
                    help="disable the streaming rbf_matvec mean path")
    ap.add_argument("--online", action="store_true",
                    help="interleave observe and predict streams (sliding-"
                         "window experts, incremental factor updates, "
                         "swapped into the engine between micro-batches)")
    ap.add_argument("--observe-every", type=int, default=4,
                    help="fleet-wide observations ingested between "
                         "prediction micro-batches (online mode)")
    ap.add_argument("--eta-nn", type=float, default=0.1,
                    help="CBNN participation threshold (paper eq. 39)")
    ap.add_argument("--sparse-m", type=int, default=None, metavar="M",
                    help="per-agent inducing count: fit/serve sparse "
                         "pseudo-representation experts (core.sparse) "
                         "instead of the dense O(Ni^2) factors; required "
                         "by the sparse trainers and method npae-sparse")
    ap.add_argument("--inducing-init", default="stride",
                    choices=("stride", "random"),
                    help="inducing-point initialization for --sparse-m "
                         "fleets")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"),
                    help="data and factor dtype (the kernels compute in "
                         "float32 either way, as the reference does under "
                         "x64); float64 for --sparse-m in the hundreds, "
                         "where a float32 Kmm Cholesky fails")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--save-fleet", default=None, metavar="DIR",
                    help="after fitting, persist the fleet (factors + "
                         "config + graph) with GPFleet.save")
    ap.add_argument("--from-checkpoint", default=None, metavar="DIR",
                    help="GPFleet.load a saved fleet and serve it without "
                         "refitting (build and train flags are ignored)")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="at exit, write the Prometheus text dump of the "
                         "metrics registry to PATH")
    args = ap.parse_args(argv)
    if args.train_iters < 0:
        ap.error("--train-iters must be >= 0")
    if args.observe_every < 0:
        ap.error("--observe-every must be >= 0")
    try:
        _serve(args, ap)
    finally:
        if args.metrics_dump:
            with open(args.metrics_dump, "w") as fh:
                fh.write(prometheus_text())
            print(f"metrics dump (Prometheus text) -> {args.metrics_dump}")


def _load(args, ap, device):
    """The --from-checkpoint fleet, with a --method override folded into
    its config (validated like a built config). Returns (fleet, method)."""
    fleet = GPFleet.load(args.from_checkpoint, device=device)
    method = args.method or fleet.config.method
    if args.online and not fleet.config.online:
        ap.error("--online: this checkpoint was not saved from an online "
                 "fleet (no window state to resume); refit with --online "
                 "--save-fleet")
    if not method.startswith("cen_"):
        try:
            fleet.config = fleet.config.replace(method=method)
            validate_config(fleet.config)
        except ValueError as e:
            ap.error(str(e))
    if "grbcm" in method and fleet.fitted_aug is None:
        ap.error(f"checkpoint carries no augmented/communication experts "
                 f"for {method}; save the fleet with a grbcm method "
                 f"configured")
    return fleet, method


def _serve(args, ap):
    """Build (or load) the fleet and serve it in the mode the flags
    select."""
    method = args.method or FleetConfig.method
    if args.online and method.startswith("cen_"):
        ap.error("centralized cen_* references serve on the replicated "
                 "engine only")
    device = resolve_device(args.device)
    gen = torch.Generator(device).manual_seed(0)
    t0 = time.perf_counter()
    if args.from_checkpoint:
        fleet, method = _load(args, ap, device)
        if args.save_fleet:
            print(f"fleet re-saved -> {fleet.save(args.save_fleet)}")
        _sync(device)
        dtype = fleet.fitted.Xp.dtype
        print(f"fleet: M={fleet.num_agents} agents x "
              f"Ni={fleet.fitted.Xp.shape[1]} points (replicated, "
              f"{str(dtype).removeprefix('torch.')}, {device}); loaded "
              f"from {args.from_checkpoint} (no refit) in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    else:
        fleet = _build(args, method, device, gen)
        if args.save_fleet:
            print(f"fleet saved -> {fleet.save(args.save_fleet)}")
    _serve_batches(args, fleet, method, gen)


def _build(args, method, device, gen):
    """The synthetic fleet of the flags, fitted (and trained with
    --train-iters)."""
    base = method[4:] if method.startswith("cen_") else method
    cfg = FleetConfig(num_agents=args.agents, method=base, chunk=args.chunk,
                      dac_iters=args.dac_iters, eta_nn=args.eta_nn,
                      stream_mean=not args.no_stream, trainer=args.trainer,
                      admm_iters=args.train_iters or FleetConfig.admm_iters,
                      fact_steps=args.train_iters or FleetConfig.fact_steps,
                      online=args.online, sparse_m=args.sparse_m,
                      inducing_init=args.inducing_init)
    t0 = time.perf_counter()
    dtype = getattr(torch, args.dtype)
    Xp, yp = build_data(gen, args.agents, args.per_agent, dtype)
    # the synthetic-fleet launcher always starts from the TRUE theta:
    # --train-iters 0 serves it directly, N runs the trainer from there
    fleet = GPFleet(cfg, device=device).fit(
        Xp, yp, generator=gen, log_theta0=pack(*_TRUE_THETA, dtype=dtype),
        train=bool(args.train_iters))
    _sync(device)
    trained = (f"trained ({args.trainer}, {args.train_iters} rounds) and "
               if args.train_iters else "")
    sparse = (f", sparse m={fleet.fitted.Z.shape[1]}"
              if args.sparse_m is not None else "")
    print(f"fleet: M={args.agents} agents x Ni={args.per_agent} points "
          f"(replicated{sparse}, {args.dtype}, {device}); {trained}"
          f"fitted in {(time.perf_counter() - t0) * 1e3:.1f} ms")
    if args.train_iters:
        theta = torch.exp(fleet.log_theta).tolist()
        print("trained theta (l_1..l_D, sigma_f, sigma_eps): "
              + ", ".join(f"{t:.4f}" for t in theta))
    return fleet


def _serve_batches(args, fleet: GPFleet, method: str, gen):
    """Ragged requests, micro-batched, served through `fleet` (or the
    streaming loop with --online)."""
    device, dtype = fleet.device, fleet.fitted.Xp.dtype
    requests = request_stream(gen, args.requests, args.batch, dtype)
    batches, total, slices = micro_batches(requests, args.batch)
    print(f"queue: {args.requests} requests, {total} queries "
          f"-> {batches.shape[0]} micro-batches of {args.batch}")

    if args.online:
        serve_online(args, fleet, method, batches, total, gen)
        return

    fleet.predict(batches[0], method=method)             # warm-up
    _sync(device)
    t0 = time.perf_counter()
    means = [fleet.predict(b, method=method)[0] for b in batches]
    _sync(device)
    dt = time.perf_counter() - t0
    flat = torch.cat(means)
    answers = [flat[a:b] for a, b in slices]            # per request
    print(f"{method}: served {total} queries in {dt * 1e3:.1f} ms "
          f"({total / dt:.0f} q/s, {len(batches) / dt:.1f} batches/s, "
          f"stream_mean={fleet.config.stream_mean}); "
          f"last request -> {answers[-1].shape[0]} predictions")


if __name__ == "__main__":
    main()
