"""Seeded agent trajectories: smooth momentum walks over the mission area.

A copy of `repro.scenario.trajectories` (numpy only): both packages draw
array-equal paths from the same config.

Every agent's FULL path (warm-up + mission) is precomputed host-side from
`np.random.default_rng` seeded by (cfg.seed, agent id), which buys three
scenario invariants for free:

  - replay: same config => bit-identical paths, no matter what the chaos
    plan does to the fleet;
  - membership independence: a dropped robot keeps moving along its path
    (it stops communicating, not driving), so a rejoin resumes seamlessly
    at its CURRENT position and can backfill its window from the stretch
    it sensed while out of contact;
  - seed sensitivity: a different seed re-draws every path (asserted by
    the two-seed test).

The walk itself: a random start in [lo, hi]^D, a persistent heading
diffused by `turn_std` Gaussian turns, fixed `step_size` steps, and
reflection at the area boundary — a cheap stand-in for the waypoint
missions of the multi-robot papers (PAPERS.md 1805.09266, 2502.05301).
"""
from __future__ import annotations

import numpy as np


def agent_paths(cfg) -> np.ndarray:
    """(M, warmup_obs + steps, D) float64 positions, agent-seeded."""
    M, D = cfg.num_agents, cfg.input_dim
    T = cfg.warmup_obs + cfg.steps
    lo, hi = float(cfg.lo), float(cfg.hi)
    paths = np.empty((M, T, D), dtype=np.float64)
    for a in range(M):
        rng = np.random.default_rng([int(cfg.seed), 0x7A11, a])
        pos = rng.uniform(lo, hi, D)
        heading = rng.normal(size=D)
        heading /= np.linalg.norm(heading)
        for t in range(T):
            paths[a, t] = pos
            heading = heading + cfg.turn_std * rng.normal(size=D)
            heading /= max(np.linalg.norm(heading), 1e-12)
            pos = pos + cfg.step_size * heading
            # reflect off the area boundary (and fold the heading with it)
            for d in range(D):
                if pos[d] < lo:
                    pos[d] = 2 * lo - pos[d]
                    heading[d] = -heading[d]
                elif pos[d] > hi:
                    pos[d] = 2 * hi - pos[d]
                    heading[d] = -heading[d]
    return paths
