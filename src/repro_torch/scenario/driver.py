"""The closed-loop mission driver: one deterministic, replayable run.

Counterpart of `repro.scenario.driver`. `run_scenario(cfg)` executes the
multi-robot story against a seeded latent field (field.py) along seeded
trajectories (trajectories.py), on `device` (default: cuda) in `dtype`:

  per fleet step t:
    1. membership chaos — the fault plan's dropout windows, at fleet-step
       granularity (`membership_events`), feed `GPFleet.leave` /
       `GPFleet.join` (rejoiners backfill their window from the path
       stretch they sensed while out of contact);
    2. observe — every live agent streams its position's sensor reading
       into its sliding window (the rank-1 factor update, one cholupdate
       launch a step on the card, swapped into the engine in place);
    3. drift-retrain — every `drift_every` steps the fleet re-runs the
       configured ADMM trainer on the live windows (`GPFleet.drift`);
    4. serve — `queries_per_step` requests enter the serving scheduler
       front door, pumped synchronously with `step(force=True)`, so the
       dispatch order (and the serving-fault sequence riding it) is
       deterministic; the scheduler path carries the scenario's serving
       plan (degraded consensus, stragglers, injected failures);
    5. measure — RMSE / NLL of clean predictions against the noiseless
       latent field on a fixed held-out eval set, fleet size, and the
       degraded fraction of dispatched batches.

Every world draw — observation noise, the eval set, the query positions —
comes from `_world_draws`, on the host with numpy, one stream of
(cfg.seed, stream id) per use, so the CPU and the card replay the same
world. The served posterior mean rides the fused Gram-matvec kernel
(FleetConfig(stream_mean=True): one rbf_matvec launch per query tile on
the card), where the reference's config serves it by triangular solves;
in float64 the two agree to roundoff.

The driver is single-threaded (`autostart=False` scheduler, no watchdog):
the curves, the membership timeline and the drift NLLs are a function of
the config, the device and the dtype, and `ScenarioResult.replay_digest()`
fingerprints that deterministic subset (latency quantiles and deadline
drops measure the machine and are excluded).
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

import numpy as np
import torch

from ..chaos import membership_events
from ..device import resolve_device
from ..fleet import GPFleet
from ..launch.scheduler import DeadlineExceeded, ServingScheduler
from .config import ScenarioConfig
from .field import make_field
from .trajectories import agent_paths

__all__ = ["ScenarioResult", "run_scenario", "validate_bench"]

_NOISE, _EVAL, _QUERIES = 1, 2, 3     # world-draw stream ids


@dataclass
class ScenarioResult:
    """One mission's outcome: accuracy-over-time curves, the chaos /
    membership timeline, serving statistics, and end-state invariants."""
    config: dict
    curves: dict           # step / rmse / nll / alive / degraded_fraction
    drift_steps: list      # fleet steps where ADMM drift-retrain ran
    drift_nll: list        # eval NLL right after each drift epoch
    membership: list       # (step, "leave" | "rejoin", original agent id)
    recompile_steps: list  # steps where the engine traced new programs
    serving: dict          # submitted/completed/dropped/failed/p50/p99 ...
    hung_futures: int      # futures still unresolved after close(drain)
    jit_cache_misses: int  # engine trace count at mission end
    health: dict           # GPFleet.health() at mission end

    def replay_digest(self) -> str:
        """SHA-256 over the DETERMINISTIC mission outputs (accuracy
        curves bit-for-bit via float hex, fleet-size curve, membership
        timeline, drift epochs). Wall-clock serving metrics (latencies,
        deadline drops) are excluded: they measure the machine, not the
        mission."""
        payload = {
            "step": [int(v) for v in self.curves["step"]],
            "rmse": [float(v).hex() for v in self.curves["rmse"]],
            "nll": [float(v).hex() for v in self.curves["nll"]],
            "alive": [int(v) for v in self.curves["alive"]],
            "drift_steps": [int(v) for v in self.drift_steps],
            "drift_nll": [float(v).hex() for v in self.drift_nll],
            "membership": [[int(s), k, int(a)]
                           for s, k, a in self.membership],
        }
        return hashlib.sha256(
            json.dumps(payload, sort_keys=True).encode()).hexdigest()

    def to_bench(self) -> dict:
        """The BENCH_scenario.json "scenario" section (validate_bench
        checks this shape)."""
        return {
            "config": self.config,
            "curves": self.curves,
            "drift": {"step": list(self.drift_steps),
                      "nll": list(self.drift_nll)},
            "serving": dict(self.serving),
            "invariants": {
                "hung_futures": int(self.hung_futures),
                "recompile_steps": list(self.recompile_steps),
                "membership": [list(m) for m in self.membership],
                "jit_cache_misses": int(self.jit_cache_misses),
                "graph_connected": bool(self.health["graph_connected"]),
                "final_agents": int(self.health["num_agents"]),
                "replay_digest": self.replay_digest(),
            },
        }


_CURVE_KEYS = ("step", "rmse", "nll", "alive", "degraded_fraction")
_SERVING_KEYS = ("submitted", "completed", "dropped", "failed", "retried",
                 "p50_ms", "p99_ms")
_INVARIANT_KEYS = ("hung_futures", "recompile_steps", "membership",
                   "jit_cache_misses", "graph_connected", "final_agents",
                   "replay_digest")


def validate_bench(doc: dict) -> None:
    """Schema check for a BENCH_scenario.json document (the CI smoke and
    the test pack both call this). Raises ValueError with the first
    problem found; returns None when the document is well-formed."""
    if "scenario" not in doc:
        raise ValueError("missing top-level 'scenario' section")
    sc = doc["scenario"]
    for k in ("config", "curves", "drift", "serving", "invariants"):
        if k not in sc:
            raise ValueError(f"scenario section missing {k!r}")
    ScenarioConfig.from_dict(sc["config"])   # config must round-trip
    curves = sc["curves"]
    lengths = set()
    for k in _CURVE_KEYS:
        if k not in curves or not isinstance(curves[k], list):
            raise ValueError(f"curves missing list {k!r}")
        lengths.add(len(curves[k]))
    if lengths == {0} or len(lengths) != 1:
        raise ValueError(f"curve lists must share one non-zero length, "
                         f"got lengths {sorted(lengths)}")
    drift = sc["drift"]
    if set(drift) != {"step", "nll"} or len(drift["step"]) != \
            len(drift["nll"]):
        raise ValueError("drift section needs equal-length step/nll lists")
    for k in _SERVING_KEYS:
        if k not in sc["serving"]:
            raise ValueError(f"serving section missing {k!r}")
    inv = sc["invariants"]
    for k in _INVARIANT_KEYS:
        if k not in inv:
            raise ValueError(f"invariants section missing {k!r}")
    if not (isinstance(inv["hung_futures"], int)
            and inv["hung_futures"] >= 0):
        raise ValueError("hung_futures must be a non-negative int")
    digest = inv["replay_digest"]
    if not (isinstance(digest, str) and len(digest) == 64
            and all(c in "0123456789abcdef" for c in digest)):
        raise ValueError("replay_digest must be a sha256 hex string")


def _classify(futures):
    """(completed, dropped, failed) across resolved futures."""
    completed = dropped = failed = 0
    for fut in futures:
        if not fut.done():
            continue
        if fut.cancelled():
            failed += 1
            continue
        exc = fut.exception()
        if exc is None:
            completed += 1
        elif isinstance(exc, DeadlineExceeded):
            dropped += 1
        else:
            failed += 1
    return completed, dropped, failed


def _world_draws(cfg: ScenarioConfig, M: int, T: int, D: int) -> dict:
    """The mission's world draws on the host, float64 numpy, one stream
    per use: "noise" (M, T) standard normals (the sensor noise of every
    agent at every path position), "eval" (eval_points, D) and "queries"
    (steps, queries_per_step, query_rows, D) uniform over the mission
    area."""
    def rng(stream):
        return np.random.default_rng([int(cfg.seed), 0x3C3, stream])
    lo, hi = float(cfg.lo), float(cfg.hi)
    return {
        "noise": rng(_NOISE).standard_normal((M, T)),
        "eval": rng(_EVAL).uniform(lo, hi, (cfg.eval_points, D)),
        "queries": rng(_QUERIES).uniform(
            lo, hi, (cfg.steps, cfg.queries_per_step, cfg.query_rows, D)),
    }


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def run_scenario(cfg: ScenarioConfig, *, csv=None, device=None,
                 dtype=torch.float64) -> ScenarioResult:
    """Execute one closed-loop mission on `device` (default: cuda) with
    the fleet, the field and the world in `dtype`. See the module
    docstring for the per-step protocol; `csv` (a print-like callable)
    gets one progress line per accuracy-curve sample."""
    log = csv if csv is not None else (lambda line: None)
    dev = resolve_device(device)
    field = make_field(cfg, dtype=dtype, device=dev)
    paths = agent_paths(cfg)
    M, T, D = paths.shape
    w = cfg.warmup_obs
    draws = _world_draws(cfg, M, T, D)
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype

    # world observations: precomputed for every (agent, time) so dropped
    # robots keep sensing along their paths and replay never depends on
    # the chaos plan
    P = torch.tensor(paths, dtype=dtype, device=dev)
    ys = field.observe(P.reshape(-1, D), draws["noise"].reshape(-1)
                       ).reshape(M, T)

    # initial fit: decentralized ADMM from the (misspecified) theta0 on
    # the warm-up stretch of every trajectory, windows seeded from it
    fleet = GPFleet(cfg.fleet_config().replace(stream_mean=True),
                    device=dev)
    fleet.fit(P[:, :w], ys[:, :w])

    # held-out ground-truth eval set (fixed geometry)
    Xe = torch.tensor(draws["eval"], dtype=dtype, device=dev)
    fe = _host(field.f(Xe))

    def evaluate():
        mean, var, _ = fleet.predict(Xe)
        mean, var = _host(mean), _host(var)
        rmse = float(np.sqrt(np.mean((mean - fe) ** 2)))
        nll = float(np.mean(0.5 * np.log(2.0 * np.pi * var)
                            + 0.5 * (fe - mean) ** 2 / var))
        return rmse, nll

    # front door: synchronous (autostart=False) so dispatch order — and
    # the serving-fault injection sequence riding it — replays exactly
    sched = ServingScheduler(autostart=False, max_wait_ms=0.0)
    sched.add_fleet("mission", fleet, max_slot=cfg.max_slot,
                    deadline_policy=cfg.deadline_policy,
                    fault_plan=cfg.serving_plan(), warm=True)

    # serve the clean eval geometry once, then baseline the geometry
    # counter: anything new past here is a recompile the result accounts
    # for
    evaluate()
    misses_prev = fleet.jit_cache_misses

    events = membership_events(cfg.membership_plan(), M, cfg.steps)
    ev_by_step: dict[int, list] = {}
    for st, kind, agent in events:
        ev_by_step.setdefault(st, []).append((kind, agent))

    ids = list(range(M))          # original agent id per current fleet index
    futures = []
    curves = {k: [] for k in _CURVE_KEYS}
    drift_steps: list[int] = []
    drift_nll: list[float] = []
    membership_log: list[tuple[int, str, int]] = []
    recompile_steps: list[int] = []
    stats = sched.tenant_stats["mission"]
    degr_prev = fleet.health()["degraded_predictions"]
    batch_prev = stats.batches

    for t in range(cfg.steps):
        # 1. membership chaos (leaves before rejoins at the same step)
        for kind, orig in ev_by_step.get(t, []):
            if kind == "leave" and orig in ids and len(ids) > 2:
                fleet.leave(ids.index(orig))
                ids.remove(orig)
                membership_log.append((t, "leave", orig))
            elif kind == "rejoin" and orig not in ids:
                s0 = max(0, w + t - cfg.warmup_obs)
                fleet.join(P[orig, s0:w + t], ys[orig, s0:w + t])
                ids.append(orig)
                membership_log.append((t, "rejoin", orig))

        # 2. every live robot observes its current position
        fleet.observe(P[ids, w + t], ys[ids, w + t])

        # 3. drift-retrain on the live windows (factors swapped in place)
        if cfg.drift_every and (t + 1) % cfg.drift_every == 0 \
                and int(fleet.window_counts.min()) >= 2:
            fleet.drift(iters=cfg.drift_iters)
            drift_steps.append(t)
            drift_nll.append(evaluate()[1])

        # 4. mid-mission queries through the scheduler front door
        for j in range(cfg.queries_per_step):
            Xq = draws["queries"][t, j].astype(np_dtype)
            futures.append(sched.add_request(Xq,
                                             deadline_ms=cfg.deadline_ms))
        while sched.step(force=True):
            pass

        # 5. accuracy-over-time + serving-health curves
        if t % cfg.eval_every == 0 or t == cfg.steps - 1:
            rmse, nll = evaluate()
            degr = fleet.health()["degraded_predictions"]
            batches = stats.batches
            frac = ((degr - degr_prev) / (batches - batch_prev)
                    if batches > batch_prev else 0.0)
            degr_prev, batch_prev = degr, batches
            curves["step"].append(t)
            curves["rmse"].append(rmse)
            curves["nll"].append(nll)
            curves["alive"].append(len(ids))
            curves["degraded_fraction"].append(float(frac))
            log(f"scenario,step={t},alive={len(ids)},rmse={rmse:.4f},"
                f"nll={nll:.4f},degraded={frac:.2f}")

        misses = fleet.jit_cache_misses
        if misses > misses_prev:
            recompile_steps.append(t)
            misses_prev = misses

    while sched.step(force=True):
        pass
    sched.close(drain=True, timeout=60.0)

    hung = sum(1 for fut in futures if not fut.done())
    completed, dropped, failed = _classify(futures)
    p50, p99 = stats.latency_ms(50, 99)
    serving = {
        "submitted": len(futures), "completed": completed,
        "dropped": dropped, "failed": failed, "retried": stats.retried,
        "p50_ms": float(p50), "p99_ms": float(p99),
    }
    return ScenarioResult(
        config=cfg.to_dict(), curves=curves, drift_steps=drift_steps,
        drift_nll=drift_nll, membership=membership_log,
        recompile_steps=recompile_steps, serving=serving,
        hung_futures=hung, jit_cache_misses=fleet.jit_cache_misses,
        health=fleet.health())
