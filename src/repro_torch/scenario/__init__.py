"""Closed-loop multi-robot scenario harness (replayable integration pack).

Counterpart of `repro.scenario`. One seed-complete, JSON round-trippable
`ScenarioConfig` describes a full mission — M agents traversing a latent
sampled field, streaming window observations, drift-retraining with
decentralized ADMM, answering queries through the serving scheduler,
absorbing a seeded chaos plan — and `run_scenario` replays it
bit-identically on one device and dtype (same config => same
`ScenarioResult.replay_digest()`). The world is drawn on the host with
numpy, so a run on the card and a run on the CPU see the same field,
paths, noise and queries.
"""
from .config import ScenarioConfig, preset
from .driver import ScenarioResult, run_scenario, validate_bench
from .field import LatentField, make_field
from .trajectories import agent_paths

__all__ = [
    "ScenarioConfig", "preset",
    "ScenarioResult", "run_scenario", "validate_bench",
    "LatentField", "make_field", "agent_paths",
]
