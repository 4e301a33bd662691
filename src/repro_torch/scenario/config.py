"""ScenarioConfig: one seed-complete description of a closed-loop mission.

Counterpart of `repro.scenario.config`, field for field, with the same
validation, presets and JSON, so a config written by either package
loads in the other. A scenario is a deterministic multi-robot story: M
agents traverse a latent sampled field along seeded trajectories, stream
observations into their sliding windows, periodically drift-retrain
hyperparameters with decentralized ADMM, answer queries mid-mission
through the serving scheduler, and absorb a seeded chaos plan (dropout/
rejoin, degraded consensus, stragglers, injected failures). Everything
stochastic derives from `seed` (the world: field draw, trajectories,
observation noise, query positions) and `fault_seed` (the chaos plan), so
a config replays bit-identically.

Chaos fields map onto `repro_torch.chaos.FaultPlan` in two disjoint plans:

  membership_plan()   the dropout windows, reinterpreted at fleet-step
                      granularity (`membership_events`) and fed to
                      `GPFleet.leave`/`join` by the driver.
  serving_plan()      edge_loss / nan_agents (degraded consensus on the
                      scheduler's predict path) + stragglers / injected
                      failures (`wrap_predict_fn` on dispatch).

`nan_agents` cannot be combined with `dropouts`: payload-corruption
indices refer to the CURRENT fleet, and leaves renumber agents.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass

from ..chaos import Dropout, FaultPlan
from ..fleet import FleetConfig

_TOPOLOGIES = ("path", "cycle", "complete")


@dataclass(frozen=True)
class ScenarioConfig:
    # -- determinism ---------------------------------------------------------
    seed: int = 0                 # world seed: field, paths, noise, queries
    fault_seed: int = 0           # chaos seed (repro_torch.chaos.FaultPlan)

    # -- fleet ---------------------------------------------------------------
    num_agents: int = 4
    input_dim: int = 2
    graph: str = "cycle"          # consensus topology: path | cycle | complete
    trainer: str = "dec-apx"      # drift-retrain loop (registry name)
    method: str = "rbcm"          # serving method (registry name)
    theta0: tuple = (1.2, 1.2, 1.0, 0.3)   # deliberately misspecified start
    window: int = 24              # sliding-window size W
    chunk: int = 16               # engine query-tile size
    dac_iters: int = 100
    admm_iters: int = 10          # initial (warm-up) fit budget
    rho: float = 500.0
    kappa: float = 5_000.0

    # -- latent ground-truth field ------------------------------------------
    field_theta: tuple = (0.8, 0.8, 1.3, 0.1)   # (l_1..l_D, sf, se) linear
    field_features: int = 256     # RFF features of the sampled field
    lo: float = 0.0               # mission area [lo, hi]^D
    hi: float = 2.0

    # -- mission timeline ----------------------------------------------------
    warmup_obs: int = 6           # per-agent observations before step 0
    steps: int = 12               # closed-loop fleet steps
    step_size: float = 0.3        # trajectory step length
    turn_std: float = 0.6         # heading diffusion (momentum walk)
    drift_every: int = 4          # ADMM retrain cadence in steps (0: never)
    drift_iters: int = 6          # ADMM iterations per drift epoch
    eval_every: int = 1           # accuracy-curve cadence in steps
    eval_points: int = 48         # held-out ground-truth eval set size

    # -- serving (scheduler front door) --------------------------------------
    queries_per_step: int = 2
    query_rows: int = 5           # rows per mid-mission request
    max_slot: int = 32            # slot-ladder ceiling
    deadline_ms: float | None = None
    deadline_policy: str = "drop"

    # -- chaos ---------------------------------------------------------------
    dropouts: tuple = ()          # (agent, at_step, until_step|None) triples
    edge_loss: float = 0.0        # degraded consensus on the serving path
    nan_agents: tuple = ()        # NaN-corrupted payloads (no dropouts)
    straggle_every: int = 0       # every k-th scheduler dispatch sleeps ...
    straggle_ms: float = 0.0      # ... this long
    fail_every: int = 0           # every k-th dispatch raises (transient)

    def __post_init__(self):
        if self.graph not in _TOPOLOGIES:
            raise ValueError(f"graph must be one of {_TOPOLOGIES}, got "
                             f"{self.graph!r}")
        for name, th in (("theta0", self.theta0),
                         ("field_theta", self.field_theta)):
            if len(th) != self.input_dim + 2:
                raise ValueError(
                    f"{name} must have input_dim + 2 = {self.input_dim + 2} "
                    f"entries (l_1..l_D, sigma_f, sigma_eps), got {len(th)}")
            object.__setattr__(self, name, tuple(float(v) for v in th))
        if self.num_agents < 2:
            raise ValueError("a multi-robot scenario needs >= 2 agents")
        if self.steps < 1 or self.warmup_obs < 2:
            raise ValueError("steps >= 1 and warmup_obs >= 2 required")
        if self.warmup_obs > self.window:
            raise ValueError(f"warmup_obs {self.warmup_obs} exceeds window "
                             f"{self.window} (warm-up data would be evicted "
                             f"before the mission starts)")
        if not 0.0 <= self.edge_loss < 1.0:
            raise ValueError(f"edge_loss must be in [0, 1), got "
                             f"{self.edge_loss}")
        # normalize dropouts to hashable (agent, at, until) int triples
        norm = []
        for d in self.dropouts:
            a, at, until = (d.agent, d.at, d.until) \
                if isinstance(d, Dropout) else tuple(d)
            norm.append((int(a), int(at),
                         None if until is None else int(until)))
        object.__setattr__(self, "dropouts", tuple(norm))
        object.__setattr__(self, "nan_agents",
                           tuple(int(a) for a in self.nan_agents))
        for a, at, until in self.dropouts:
            if not 0 <= a < self.num_agents:
                raise ValueError(f"dropout agent {a} not in fleet of "
                                 f"{self.num_agents}")
            if at < 0 or (until is not None and until <= at):
                raise ValueError(f"dropout window at={at} until={until} is "
                                 f"empty or negative")
        if self.nan_agents and self.dropouts:
            raise ValueError(
                "nan_agents cannot be combined with dropouts: leaves "
                "renumber agents, so a payload-corruption index would "
                "silently point at a different robot mid-mission")
        if len({a for a, _, _ in self.dropouts}) > self.num_agents - 2:
            raise ValueError(
                "dropouts may not name more than num_agents - 2 distinct "
                "agents (the mission must keep a >= 2-agent fleet)")

    def replace(self, **kw) -> "ScenarioConfig":
        return dataclasses.replace(self, **kw)

    # -- derived configs -----------------------------------------------------

    def fleet_config(self) -> FleetConfig:
        """The streaming FleetConfig this scenario drives."""
        return FleetConfig(
            input_dim=self.input_dim, theta0=self.theta0,
            num_agents=self.num_agents, graph=self.graph,
            trainer=self.trainer, method=self.method,
            rho=self.rho, kappa=self.kappa, admm_iters=self.admm_iters,
            chunk=self.chunk, dac_iters=self.dac_iters,
            online=True, window=self.window)

    def membership_plan(self) -> FaultPlan:
        """Dropout windows only — the driver feeds
        `membership_events(plan, M, steps)` into GPFleet.leave/join."""
        return FaultPlan(seed=self.fault_seed, dropouts=tuple(
            Dropout(a, at, until) for a, at, until in self.dropouts))

    def serving_plan(self) -> FaultPlan | None:
        """Consensus degradation + serving faults for the scheduler path
        (None when this scenario serves clean)."""
        plan = FaultPlan(seed=self.fault_seed, edge_loss=self.edge_loss,
                         nan_agents=self.nan_agents,
                         straggle_every=self.straggle_every,
                         straggle_ms=self.straggle_ms,
                         fail_every=self.fail_every)
        return None if plan.empty else plan

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ScenarioConfig fields "
                             f"{sorted(unknown)} (config saved by a newer "
                             f"version?)")
        d = dict(d)
        for k in ("theta0", "field_theta", "nan_agents"):
            if k in d:
                d[k] = tuple(d[k])
        if "dropouts" in d:
            d["dropouts"] = tuple(tuple(t) for t in d["dropouts"])
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ScenarioConfig":
        return cls.from_dict(json.loads(s))


# -- named presets (the three shipping surfaces share these) -----------------

def preset(name: str) -> ScenarioConfig:
    """Named mission presets.

      smoke    seconds-scale clean mission (CI tier-1 / bench --smoke)
      mission  the default closed-loop story: longer traversal, drift
               retrains, mid-mission queries, no chaos
      chaos    mission + one dropout/rejoin, degraded consensus edge
               loss, a straggler cadence, and injected transient failures
    """
    base = ScenarioConfig()
    presets = {
        "smoke": base.replace(steps=8, warmup_obs=5, window=16,
                              dac_iters=60, admm_iters=6, drift_every=3,
                              drift_iters=4, eval_points=32,
                              field_features=128, queries_per_step=1,
                              query_rows=4, max_slot=16),
        # the long mission serves gpoe: rBCM's precision-summing grows
        # overconfident far from the trajectories as windows fill (NLL
        # degrades even as RMSE halves); gpoe's normalized weights keep
        # the NLL story monotone across drift epochs
        "mission": base.replace(steps=24, num_agents=6, window=32,
                                drift_every=6, method="gpoe"),
        "chaos": base.replace(
            steps=16, num_agents=5, window=24, drift_every=5,
            dropouts=((1, 4, 10),), edge_loss=0.05,
            straggle_every=5, straggle_ms=10.0, fail_every=7,
            deadline_ms=5_000.0),
    }
    if name not in presets:
        raise ValueError(f"unknown scenario preset {name!r}; one of "
                         f"{sorted(presets)}")
    return presets[name]
