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

`--sharded` serves the fleet from the agent-sharded engine
(FleetConfig(sharded=True), `core.prediction.ShardedEngine`): per-agent
moments member-locally on the agent mesh (`launch.mesh`: the visible
cards, or the one CPU device with `--device cpu`), cross-agent sums on the
ring of members. `--routed` (implies `--sharded`) serves the CBNN nn_*
methods by query routing: each query on the member holding its
most-correlated experts.

  PYTHONPATH=src python -m repro_torch.launch.serve_gp --device cpu \
      --agents 4 --per-agent 64 --method nn-rbcm --sharded --routed

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

Front-door serving, as in the reference:

  --async-door    serve through `GPFleet.to_server` (the one-tenant
                  serving scheduler): requests are submitted as they
                  arrive and resolved through futures, slots cut by size
                  or the --max-wait-ms latency bound.
  --scheduler     the request-level `launch.scheduler.ServingScheduler`:
                  continuous slot batching with admission control,
                  priorities and deadlines (--deadline-ms,
                  --deadline-policy, --priority) and several resident
                  fleets in one process: each `--tenant NAME=SPEC` (SPEC a
                  method name for a synthetic fleet, or a GPFleet.save
                  checkpoint directory) serves round-robin.
                  `--loadgen RATE --duration S` drives it open-loop with
                  Poisson arrivals per tenant (admission then rejects, so
                  saturation shows as rejected counts); --trace-log
                  appends one JSONL span per request; --stall-timeout-ms
                  arms the watchdog.
  --fault-*       a seeded `chaos.FaultPlan` over the scheduler's
                  tenants: consensus faults (--fault-dropout
                  AGENT[:AT[:UNTIL]], --fault-edge-loss,
                  --fault-nan-agent) serve degraded, flagged predictions;
                  serving faults (--fault-straggle-every/-ms,
                  --fault-fail-every) exercise the retries, isolation and
                  the watchdog. Every future resolves, and serving meets
                  no geometry that registration did not serve.
  --metrics-port  GET /metrics (Prometheus text) and /statusz on
                  127.0.0.1:PORT while the run lasts (0: any free port).
  --compare-uncached  also times the per-call path (the registry's
                  `legacy_call`, refactorizing every agent's kernel matrix
                  per batch) on the same micro-batches.

  PYTHONPATH=src python -m repro_torch.launch.serve_gp --device cpu \
      --agents 4 --per-agent 64 --chunk 32 --batch 128 --scheduler \
      --loadgen 20 --duration 1 --fault-dropout 0 --fault-fail-every 5
"""
from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import TimeoutError as FutureTimeout

import numpy as np
import torch

from ..core.gp import pack, stripe_partition
from ..data import gp_sample_field, random_inputs
from ..device import resolve_device
from ..fleet import (FleetConfig, GPFleet, get_method, method_names,
                     trainer_names, validate_config)
from ..obs import prometheus_text, start_metrics_server
from .scheduler import (DeadlineExceeded, SchedulerSaturated,
                        SchedulerStalled, ServingScheduler)

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


def serve_async(args, fleet: GPFleet, method: str, requests) -> None:
    """Serve the request stream through `GPFleet.to_server` (the one-
    tenant scheduler): submitted as fast as clients produce them, resolved
    through futures, slots cut by size or the --max-wait-ms bound."""
    requests = [r.cpu().numpy() for r in requests]   # what clients send
    t0 = time.perf_counter()
    with fleet.to_server(args.batch, max_wait_ms=args.max_wait_ms,
                         method=method) as door:
        futures = [door.submit(r) for r in requests]
        answers = [f.result(timeout=600) for f in futures]
    dt = time.perf_counter() - t0
    st = door.stats
    if not all(a[0].shape[0] == r.shape[0]
               for a, r in zip(answers, requests)):
        raise AssertionError("an answer does not match its request's rows")
    print(f"async {method}: {st.requests} requests / {st.queries} "
          f"queries in {dt * 1e3:.1f} ms ({st.queries / dt:.0f} q/s "
          f"end-to-end, {st.batches} slots up to {args.batch}, padding "
          f"{100 * st.padding_fraction:.1f}%, engine busy "
          f"{st.engine_seconds * 1e3:.1f} ms)")


def _tenant_fleet(args, spec: str, ap, device, gen):
    """--tenant SPEC -> (fleet, served method). SPEC is a GPFleet.save
    checkpoint directory (served with its saved config) or a method name
    (a synthetic fleet built from the launcher flags)."""
    if os.path.isdir(spec):
        fleet = GPFleet.load(spec, device=device)
        return fleet, fleet.config.method
    method = spec.replace("-", "_")
    base = method[4:] if method.startswith("cen_") else method
    if base not in method_names():
        ap.error(f"--tenant spec {spec!r} is neither a checkpoint dir nor "
                 f"a registered method ({sorted(method_names())})")
    try:
        cfg = FleetConfig(num_agents=args.agents, method=base,
                          chunk=args.chunk, dac_iters=args.dac_iters,
                          eta_nn=args.eta_nn, stream_mean=not args.no_stream,
                          sparse_m=args.sparse_m,
                          inducing_init=args.inducing_init)
        validate_config(cfg)
    except (ValueError, KeyError) as e:
        ap.error(str(e))
    dtype = getattr(torch, args.dtype)
    Xp, yp = build_data(gen, args.agents, args.per_agent, dtype)
    fleet = GPFleet(cfg, device=device).fit(
        Xp, yp, generator=gen, log_theta0=pack(*_TRUE_THETA, dtype=dtype),
        train=False)
    return fleet, method


def build_fault_plan(args, ap):
    """--fault-* flags -> a seeded `chaos.FaultPlan` (None when no fault
    flag is set). Dropout specs are AGENT[:AT[:UNTIL]] in consensus rounds
    (AT=0: an agent dead before the prediction starts)."""
    from ..chaos import Dropout, FaultPlan
    dropouts = []
    for spec in args.fault_dropout or ():
        parts = spec.split(":")
        if not 1 <= len(parts) <= 3:
            ap.error(f"--fault-dropout wants AGENT[:AT[:UNTIL]], "
                     f"got {spec!r}")
        try:
            dropouts.append(Dropout(
                int(parts[0]),
                at=int(parts[1]) if len(parts) > 1 else 0,
                until=int(parts[2]) if len(parts) > 2 else None))
        except ValueError:
            ap.error(f"--fault-dropout fields must be integers, "
                     f"got {spec!r}")
    try:
        plan = FaultPlan(seed=args.fault_seed, dropouts=tuple(dropouts),
                         edge_loss=args.fault_edge_loss,
                         nan_agents=tuple(args.fault_nan_agent or ()),
                         straggle_every=args.fault_straggle_every,
                         straggle_ms=args.fault_straggle_ms,
                         fail_every=args.fault_fail_every)
    except ValueError as e:
        ap.error(str(e))
    return None if plan.empty else plan


def poisson_arrivals(rng, rates: dict, duration: float) -> list:
    """Open-loop Poisson arrivals: (t, tenant) events at rates[tenant]
    requests/s each, for `duration` seconds, in time order (drawn tenant
    by tenant from `rng`)."""
    events = []
    for name, rate in rates.items():
        t = rng.exponential(1.0 / rate)
        while t < duration:
            events.append((t, name))
            t += rng.exponential(1.0 / rate)
    events.sort()
    return events


def open_loop(sched, events, make_request, **request_kw):
    """Submit `make_request(tenant)` for each (t, tenant) event at its time
    from now, whether or not earlier requests have completed, so overload
    shows as rejections and latency growth. Returns (futures, rejected):
    a request refused because the tenant's queue is full or the watchdog
    has quarantined it counts as rejected."""
    futs, rejected = [], 0
    t0 = time.perf_counter()
    for at, name in events:
        lag = at - (time.perf_counter() - t0)
        if lag > 0:
            time.sleep(lag)
        try:
            futs.append(sched.add_request(make_request(name), tenant=name,
                                          **request_kw))
        except (SchedulerSaturated, SchedulerStalled):
            rejected += 1
    return futs, rejected


def serve_scheduler(args, tenants: dict, ap) -> None:
    """Serve through the request-level `ServingScheduler`: every tenant
    (name -> (fleet, method)) is a resident fleet, interleaved round-robin
    in ONE process; per-tenant quantiles and the zero-new-geometry check
    are reported at exit.

    With --fault-* flags the whole run goes through a seeded FaultPlan:
    consensus faults serve degraded (flagged) predictions, serving faults
    exercise the retry, isolation and watchdog paths. The exit contract
    under chaos: every future resolves (none hung), failures are typed,
    and serving meets no geometry registration did not serve."""
    plan = build_fault_plan(args, ap)
    sched = ServingScheduler(max_wait_ms=args.max_wait_ms,
                             span_log=args.trace_log,
                             stall_timeout_ms=args.stall_timeout_ms)
    admission = "reject" if args.loadgen else "block"
    for name, (fl, m) in tenants.items():
        sched.add_fleet(name, fl, method=m, max_slot=args.batch,
                        admission=admission,
                        deadline_policy=args.deadline_policy,
                        fault_plan=plan)
    # registration served every slot; serving must add no geometry
    misses0 = {n: fl.jit_cache_misses for n, (fl, _) in tenants.items()}
    D = next(iter(tenants.values()))[0].config.input_dim

    rng = np.random.default_rng(0)
    names = list(tenants)
    futs = []
    rejected = 0
    t0 = time.perf_counter()
    if args.loadgen:
        # --loadgen req/s PER TENANT for --duration seconds
        def request(name):
            n = int(rng.integers(1, max(2, args.batch // 2) + 1))
            return rng.uniform(0.0, 2.0, (n, D))

        events = poisson_arrivals(rng, dict.fromkeys(names, args.loadgen),
                                  args.duration)
        futs, rejected = open_loop(sched, events, request,
                                   priority=args.priority,
                                   deadline_ms=args.deadline_ms)
    else:
        for i in range(args.requests):
            name = names[i % len(names)]
            Xq = rng.uniform(0.0, 2.0, (int(rng.integers(1, args.batch + 1)),
                                        D))
            futs.append(sched.add_request(Xq, tenant=name,
                                          priority=args.priority,
                                          deadline_ms=args.deadline_ms))
    served = dropped = failed = hung = 0
    for f in futs:
        try:
            f.result(timeout=600)
            served += 1
        except DeadlineExceeded:
            dropped += 1
        except FutureTimeout:
            hung += 1             # a future that never resolved: the bug
        except Exception:
            failed += 1           # typed failure (injected, stalled, chaos)
    sched.close()
    dt = time.perf_counter() - t0
    drive = (f"open-loop Poisson {args.loadgen:.0f} req/s/tenant x "
             f"{args.duration:.1f} s" if args.loadgen
             else f"{args.requests} requests")
    print(f"scheduler: {len(tenants)} tenant(s), {drive} -> "
          f"{len(futs) + rejected} submitted: {served} "
          f"served / {dropped} past-deadline / {rejected} rejected / "
          f"{failed} failed / {hung} hung in {dt * 1e3:.1f} ms")
    if hung:
        raise AssertionError(f"{hung} futures never resolved")
    if plan is not None:
        print(f"fault plan: {plan}")
    for name, (fl, m) in tenants.items():
        st = sched.tenant_stats[name]
        p50, p99 = st.latency_ms(50, 99)
        new = fl.jit_cache_misses - misses0[name]
        print(f"  {name} ({m}): {st.requests} req / {st.queries} q in "
              f"{st.batches} slots ({st.queries / dt:.0f} q/s), padding "
              f"{100 * st.padding_fraction:.1f}%, p50 {p50:.2f} ms, p99 "
              f"{p99:.2f} ms, dropped {st.dropped}, lapsed {st.lapsed}, "
              f"rejected {st.rejected}, retried {st.retried}, isolated "
              f"{st.isolated}, stalled {st.stalled}, engine busy "
              f"{st.engine_seconds * 1e3:.1f} ms, {new} new geometries "
              f"after warm-up")
    bad = [n for n, (fl, _) in tenants.items()
           if fl.jit_cache_misses != misses0[n]]
    if bad:
        raise AssertionError(f"serving met new geometries for tenants "
                             f"{bad}")
    if args.trace_log:
        print(f"request trace (JSONL spans) -> {args.trace_log}")


def compare_uncached(fleet: GPFleet, method: str, batches, total: int,
                     dt: float) -> None:
    """Time the per-call path (the registry's `legacy_call`: refactorizes
    every agent's kernel matrix per batch) on the same micro-batches."""
    spec = get_method(method)
    cfg, f = fleet.config, fleet.fitted
    if not hasattr(f, "yp"):
        print(f"--compare-uncached: skipped for {method} (sparse experts "
              f"do not carry the raw per-agent datasets)")
        return
    Xc = yc = Xa = ya = None
    if fleet._comm_data is not None:
        Xc, yc, Xa, ya = fleet._comm_data
    elif spec.needs_augmented_data:
        print(f"--compare-uncached: skipped for {method} (the per-call "
              f"path needs the raw communication datasets, which a loaded "
              f"checkpoint does not carry)")
        return

    def call(Xq):
        return spec.legacy_call(cfg, fleet.log_theta, f.Xp, f.yp, Xq,
                                fleet.A, Xc, yc, Xa, ya)[:2]
    call(batches[0])                                      # warm-up
    _sync(fleet.device)
    t0 = time.perf_counter()
    for b in batches:
        call(b)
    _sync(fleet.device)
    dt_un = time.perf_counter() - t0
    print(f"uncached per-call path: {total / dt_un:.0f} q/s "
          f"-> engine speedup {dt_un / dt:.2f}x")


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
    ap.add_argument("--sharded", action="store_true",
                    help="shard the fleet over the agent axis of the agent "
                         "mesh (ShardedEngine; DAC-family methods and "
                         "npae-sparse)")
    ap.add_argument("--routed", action="store_true",
                    help="CBNN query routing on the sharded fleet (nn_* "
                         "methods; implies --sharded)")
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
                         "refitting (build and train flags are ignored; "
                         "--sharded/--routed deployment overrides are "
                         "honored)")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="at exit, write the Prometheus text dump of the "
                         "metrics registry to PATH")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve GET /metrics (Prometheus text) and /statusz "
                         "(registry snapshot JSON) on PORT for the run "
                         "(0 = any free port, printed at startup)")
    ap.add_argument("--async-door", action="store_true",
                    help="serve through GPFleet.to_server (submit/Future "
                         "API) instead of the synchronous loop")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="front door latency bound: max time a request "
                         "waits for its slot to fill")
    ap.add_argument("--scheduler", action="store_true",
                    help="serve through the request-level ServingScheduler "
                         "(continuous slot batching, multi-tenant)")
    ap.add_argument("--tenant", action="append", metavar="NAME=SPEC",
                    help="register a resident fleet on the scheduler "
                         "(repeatable). SPEC: a method name (synthetic "
                         "fleet from the launcher flags) or a "
                         "GPFleet.save checkpoint dir; without --tenant "
                         "the launcher fleet serves as tenant 'default'")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline; expiry follows "
                         "--deadline-policy")
    ap.add_argument("--deadline-policy", choices=("drop", "deprioritize"),
                    default="drop",
                    help="past-deadline work is dropped (its future raises "
                         "DeadlineExceeded) or served only when no "
                         "in-deadline work is pending")
    ap.add_argument("--priority", type=int, default=0,
                    help="request priority (higher packs first)")
    ap.add_argument("--loadgen", type=float, default=None, metavar="RATE",
                    help="scheduler mode: open-loop Poisson load at RATE "
                         "req/s per tenant instead of a fixed request list")
    ap.add_argument("--duration", type=float, default=2.0,
                    help="loadgen run length in seconds")
    ap.add_argument("--trace-log", default=None, metavar="PATH",
                    help="scheduler mode: append one JSONL span event per "
                         "request (per-stage timings) to PATH")
    ap.add_argument("--stall-timeout-ms", type=float, default=None,
                    help="scheduler watchdog: fail the futures of a "
                         "dispatch stalled longer than this with "
                         "SchedulerStalled and quarantine the tenant")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="chaos: seed of the replayable FaultPlan (edge "
                         "loss draws)")
    ap.add_argument("--fault-dropout", action="append", default=None,
                    metavar="AGENT[:AT[:UNTIL]]",
                    help="chaos: drop AGENT at consensus round AT "
                         "(default 0), rejoining at UNTIL (default: "
                         "never); repeatable")
    ap.add_argument("--fault-edge-loss", type=float, default=0.0,
                    help="chaos: per-round probability that each live edge "
                         "drops its message")
    ap.add_argument("--fault-nan-agent", action="append", type=int,
                    default=None, metavar="AGENT",
                    help="chaos: AGENT emits NaN payloads (scrubbed by the "
                         "degraded engine); repeatable")
    ap.add_argument("--fault-straggle-every", type=int, default=0,
                    metavar="N",
                    help="chaos: every Nth scheduler dispatch sleeps "
                         "--fault-straggle-ms before the engine call")
    ap.add_argument("--fault-straggle-ms", type=float, default=0.0)
    ap.add_argument("--fault-fail-every", type=int, default=0, metavar="N",
                    help="chaos: every Nth scheduler dispatch raises "
                         "FaultInjected (exercises retry and isolation)")
    ap.add_argument("--compare-uncached", action="store_true",
                    help="also time the per-call path (the registry's "
                         "legacy_call) on the same micro-batches")
    args = ap.parse_args(argv)
    if args.routed:
        args.sharded = True
    if args.train_iters < 0:
        ap.error("--train-iters must be >= 0")
    if args.observe_every < 0:
        ap.error("--observe-every must be >= 0")
    if (args.tenant or args.loadgen or args.trace_log) \
            and not args.scheduler:
        ap.error("--tenant/--loadgen/--trace-log belong to scheduler "
                 "serving; add --scheduler")
    chaos_flags = (args.fault_dropout or args.fault_nan_agent
                   or args.fault_edge_loss or args.fault_straggle_every
                   or args.fault_fail_every
                   or args.stall_timeout_ms is not None)
    if chaos_flags and not args.scheduler:
        ap.error("--fault-*/--stall-timeout-ms belong to scheduler "
                 "serving; add --scheduler")
    server = None
    if args.metrics_port is not None:
        server = start_metrics_server(args.metrics_port)
        print(f"metrics: http://127.0.0.1:{server.port}/metrics "
              f"(+ /statusz)")
    try:
        _serve(args, ap)
    finally:
        if args.metrics_dump:
            with open(args.metrics_dump, "w") as fh:
                fh.write(prometheus_text())
            print(f"metrics dump (Prometheus text) -> {args.metrics_dump}")
        if server is not None:
            server.stop()


def _load(args, ap, device):
    """The --from-checkpoint fleet, with a --method override folded into
    its config (validated like a built config). Returns (fleet, method)."""
    fleet = GPFleet.load(args.from_checkpoint, device=device)
    method = args.method or fleet.config.method
    if args.online and not fleet.config.online:
        ap.error("--online: this checkpoint was not saved from an online "
                 "fleet (no window state to resume); refit with --online "
                 "--save-fleet")
    if method.startswith("cen_"):
        if fleet.config.sharded or args.sharded:
            ap.error("centralized cen_* references serve on the replicated "
                     "engine only")
    else:
        try:
            fleet.config = fleet.config.replace(method=method)
            validate_config(fleet.config)
        except ValueError as e:
            ap.error(str(e))
    if args.sharded:
        # deployment overrides are honored, not silently dropped
        try:
            fleet.shard(routed=args.routed or None)
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
    if (args.online or args.sharded) and method.startswith("cen_"):
        ap.error("centralized cen_* references serve on the replicated "
                 "engine only")
    device = resolve_device(args.device)
    gen = torch.Generator(device).manual_seed(0)
    if args.scheduler and args.tenant:
        # every --tenant builds its own fleet; the launcher fleet would be
        # dead work
        tenants = {}
        for item in args.tenant:
            if "=" not in item:
                ap.error(f"--tenant wants NAME=SPEC, got {item!r}")
            name, spec = item.split("=", 1)
            if name in tenants:
                ap.error(f"duplicate tenant name {name!r}")
            tenants[name] = _tenant_fleet(args, spec, ap, device, gen)
        serve_scheduler(args, tenants, ap)
        return
    t0 = time.perf_counter()
    if args.from_checkpoint:
        fleet, method = _load(args, ap, device)
        if args.save_fleet:
            print(f"fleet re-saved -> {fleet.save(args.save_fleet)}")
        _sync(device)
        dtype = fleet.fitted.Xp.dtype
        print(f"fleet: M={fleet.num_agents} agents x "
              f"Ni={fleet.fitted.Xp.shape[1]} points ({_mode(fleet)}, "
              f"{str(dtype).removeprefix('torch.')}, {device}); loaded "
              f"from {args.from_checkpoint} (no refit) in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    else:
        fleet = _build(args, method, device, gen, ap)
        if args.save_fleet:
            print(f"fleet saved -> {fleet.save(args.save_fleet)}")
    if args.scheduler:
        serve_scheduler(args, {"default": (fleet, method)}, ap)
        return
    _serve_batches(args, fleet, method, gen)


def _mode(fleet: GPFleet) -> str:
    """How the fleet serves: replicated, or sharded over the mesh's
    members (CBNN-routed)."""
    if not fleet.config.sharded:
        return "replicated"
    return (f"sharded over {fleet.engine.ndev} device(s)"
            + (", CBNN-routed" if fleet.config.routed else ""))


def _build(args, method, device, gen, ap):
    """The synthetic fleet of the flags, fitted (and trained with
    --train-iters)."""
    base = method[4:] if method.startswith("cen_") else method
    try:
        cfg = FleetConfig(
            num_agents=args.agents, method=base, chunk=args.chunk,
            dac_iters=args.dac_iters, eta_nn=args.eta_nn,
            stream_mean=not args.no_stream, trainer=args.trainer,
            admm_iters=args.train_iters or FleetConfig.admm_iters,
            fact_steps=args.train_iters or FleetConfig.fact_steps,
            sharded=args.sharded, routed=args.routed, online=args.online,
            sparse_m=args.sparse_m, inducing_init=args.inducing_init)
        validate_config(cfg)
    except (ValueError, KeyError) as e:
        ap.error(str(e))
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
          f"({_mode(fleet)}{sparse}, {args.dtype}, {device}); {trained}"
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
    if args.async_door:
        serve_async(args, fleet, method, requests)
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
    if args.compare_uncached and not method.startswith("cen_"):
        compare_uncached(fleet, method, batches, total, dt)


if __name__ == "__main__":
    main()
