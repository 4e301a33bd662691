"""Fault-plan injection hooks for the serving and membership layers.

A copy of `repro.chaos.inject`. The consensus-layer hooks live in the
engine (core/prediction/engine.py); this module carries the HOST-SIDE
hooks:

  wrap_predict_fn   deterministic straggler delays and injected transient
                    failures on the scheduler dispatch path. The wrapper
                    keeps a thread-safe call counter, so under a fixed
                    request schedule the k-th dispatch always sees the
                    same fault — chaos runs replay.
  membership_events the plan's dropout schedule reinterpreted at fleet-
                    step granularity: (step, "leave"/"rejoin", agent)
                    events a scenario driver feeds to GPFleet.leave /
                    GPFleet.join between serving steps.
"""
from __future__ import annotations

import threading
import time

from .faults import FaultInjected, FaultPlan


def wrap_predict_fn(predict_fn, plan: FaultPlan, *, sleep=time.sleep):
    """Wrap a scheduler predict_fn with the plan's serving faults.

    Call indices are 1-based: with `fail_every=k` every k-th call raises
    `FaultInjected` BEFORE touching the engine (a transient failure the
    scheduler's retry path absorbs — the retry advances the call counter,
    so it succeeds unless k == 1); with `straggle_every=k` every k-th
    call sleeps `straggle_ms` first (a straggler the watchdog can see).
    Consensus faults are NOT injected here — pass the plan to
    `GPFleet.predict(fault_plan=...)` for those. A straggle is a host
    sleep BEFORE the engine call, so it never leaves a kernel in flight.
    """
    counter = {"n": 0}
    lock = threading.Lock()

    def chaotic(Xs):
        with lock:
            counter["n"] += 1
            n = counter["n"]
        if plan.fail_every and n % plan.fail_every == 0:
            raise FaultInjected(
                f"injected transient failure (call {n}, "
                f"fail_every={plan.fail_every})")
        if plan.straggle_every and n % plan.straggle_every == 0 \
                and plan.straggle_ms > 0.0:
            sleep(plan.straggle_ms * 1e-3)
        return predict_fn(Xs)

    chaotic.calls = counter        # test/diagnostic read surface
    return chaotic


def membership_events(plan: FaultPlan, num_agents: int,
                      steps: int) -> list[tuple[int, str, int]]:
    """The plan's dropouts as fleet-step membership events.

    Returns [(step, "leave" | "rejoin", agent), ...] sorted by step —
    `Dropout(agent, at, until)` leaves at step `at` and (when `until`
    is set within the horizon) rejoins at step `until`. Agent ids refer
    to the ORIGINAL numbering; a driver applying them must track index
    shifts across leaves (GPFleet renumbers on leave).
    """
    events = []
    for d in plan.dropouts:
        if not 0 <= d.agent < num_agents:
            raise ValueError(f"dropout agent {d.agent} not in fleet of "
                             f"{num_agents}")
        if d.at < steps:
            events.append((int(d.at), "leave", int(d.agent)))
        if d.until is not None and d.until < steps:
            events.append((int(d.until), "rejoin", int(d.agent)))
    events.sort()
    return events
