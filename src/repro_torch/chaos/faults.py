"""Seeded, replayable fault plans for the fleet (the chaos model).

A copy of `repro.chaos.faults` (numpy only, no torch).

A `FaultPlan` is an immutable description of every fault a run injects:
agent dropout/rejoin schedules, per-edge message loss, NaN-corrupted
payloads, straggler delays, and injected predict failures. It carries a
seed and derives every stochastic schedule from `np.random.default_rng`
on that seed, so a chaos run is a REGRESSION TEST: the same plan replays
the same faults, round for round, call for call.

The plan's fields split into two groups:

  consensus faults   dropouts / edge_loss / nan_agents — change the
                     numbers a prediction computes. The engines consume
                     them through `alive_schedule` / `edge_schedule` /
                     `corrupt_mask` and run the degraded consensus path
                     (core/consensus/degraded.py) with an explicit
                     degradation flag.
  serving faults     straggle_every / straggle_ms / fail_every — change
                     the TIMING or availability of a predict call, never
                     its value. Injected on the scheduler dispatch path
                     by `repro_torch.chaos.wrap_predict_fn`.

`plan.consensus_free` is the contract the bitwise-unchanged acceptance
test leans on: a plan with no consensus faults dispatches to the exact
consensus path, not an all-alive masked variant — the masked and exact
formulations agree mathematically but not bit for bit.

Round indices are CONSENSUS-ROUND indices (0-based DAC sweeps within one
prediction); `membership_events` (inject.py) reinterprets the same
dropout schedule at fleet-step granularity for online membership chaos.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


class FaultInjected(RuntimeError):
    """A fault injected by a FaultPlan (transient by construction: the
    retry path re-invokes the call under the next call index)."""


@dataclass(frozen=True)
class Dropout:
    """Agent `agent` stops exchanging consensus messages at round `at`
    (inclusive) and rejoins at round `until` (exclusive; None = never).

    A dropped agent freezes its local consensus state and neither sends
    nor receives — its row/column of the adjacency is zeroed for the
    affected rounds. `at=0` models an agent that was dead before the
    prediction started (exact masked aggregation); `at>0` models mid-run
    churn (honest degraded estimate, flagged)."""
    agent: int
    at: int = 0
    until: int | None = None


@dataclass(frozen=True)
class FaultPlan:
    """One run's faults, derived deterministically from `seed`."""
    seed: int = 0
    dropouts: Tuple[Dropout, ...] = ()
    edge_loss: float = 0.0        # iid per-edge, per-round message loss prob
    nan_agents: Tuple[int, ...] = ()   # agents with NaN-corrupted payloads
    straggle_every: int = 0       # every k-th predict call sleeps ...
    straggle_ms: float = 0.0      # ... this long (serving-path fault)
    fail_every: int = 0           # every k-th predict call raises

    def __post_init__(self):
        if not 0.0 <= self.edge_loss < 1.0:
            raise ValueError(f"edge_loss must be in [0, 1), got "
                             f"{self.edge_loss}")
        if self.straggle_every < 0 or self.fail_every < 0:
            raise ValueError("straggle_every / fail_every must be >= 0")
        # normalize to tuples so plans constructed from lists hash/compare
        object.__setattr__(self, "dropouts", tuple(
            d if isinstance(d, Dropout) else Dropout(*d)
            for d in self.dropouts))
        object.__setattr__(self, "nan_agents",
                           tuple(int(a) for a in self.nan_agents))

    # -- classification ------------------------------------------------------

    @property
    def consensus_free(self) -> bool:
        """True when the plan cannot change any computed value — only
        timing/availability (stragglers, injected call failures). The
        engines serve such plans on the EXACT consensus traces, so
        results are bitwise identical to fault-free serving."""
        return (not self.dropouts and self.edge_loss == 0.0
                and not self.nan_agents)

    @property
    def empty(self) -> bool:
        """True when the plan injects nothing at all."""
        return (self.consensus_free and self.straggle_every == 0
                and self.fail_every == 0 and self.straggle_ms == 0.0)

    # -- consensus-fault schedules (all host-side numpy, seeded) -------------

    def alive_schedule(self, num_agents: int, iters: int) -> np.ndarray:
        """(iters, M) float mask: alive[t, i] = 1 iff agent i exchanges
        messages in consensus round t."""
        alive = np.ones((iters, num_agents), dtype=np.float64)
        for d in self.dropouts:
            if not 0 <= d.agent < num_agents:
                raise ValueError(f"dropout agent {d.agent} not in fleet "
                                 f"of {num_agents}")
            hi = iters if d.until is None else min(int(d.until), iters)
            alive[int(d.at):hi, d.agent] = 0.0
        return alive

    def final_alive(self, num_agents: int, iters: int) -> np.ndarray:
        """(M,) bool: alive at the readout round (the last sweep)."""
        if iters <= 0:
            return np.ones(num_agents, dtype=bool)
        return self.alive_schedule(num_agents, iters)[-1] > 0.0

    def edge_schedule(self, num_agents: int, iters: int) -> np.ndarray | None:
        """(iters, M, M) symmetric 0/1 edge-survival masks drawn iid from
        `seed` (None when edge_loss == 0). Symmetric loss — a lost edge
        drops the message in BOTH directions — keeps every masked
        exchange conservative (the degraded estimator relies on it)."""
        if self.edge_loss == 0.0:
            return None
        rng = np.random.default_rng(self.seed)
        keep = rng.random((iters, num_agents, num_agents)) >= self.edge_loss
        upper = np.triu(keep, 1)
        return (upper + np.transpose(upper, (0, 2, 1))).astype(np.float64)

    def corrupt_mask(self, num_agents: int) -> np.ndarray:
        """(M,) bool: agents whose consensus payloads are NaN-corrupted
        (the degraded path's finite-scrub detects and excludes them)."""
        mask = np.zeros(num_agents, dtype=bool)
        for a in self.nan_agents:
            if not 0 <= a < num_agents:
                raise ValueError(f"nan agent {a} not in fleet of "
                                 f"{num_agents}")
            mask[a] = True
        return mask
