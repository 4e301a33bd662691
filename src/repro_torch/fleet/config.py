"""FleetConfig: one declarative description of a GP fleet's whole lifecycle.

Counterpart of `repro.fleet.config`, with the same fields, defaults,
validation and JSON, so a config serialized by either package loads in the
other. Switches whose subsystems the port does not have yet are rejected
by `repro_torch.fleet.registry.validate_config`, not here.

It holds the kernel hyperparameters, data partition, consensus graph
topology, the trainer name with its ADMM parameters, the prediction method
with its consensus-iteration parameters, and the serving switches
(sharding, routing, online windows). `GPFleet` consumes a config; the
`serve_gp` CLI is a thin overlay that fills one in.

The defaults reproduce the paper's §6 experiment configuration, so
`FleetConfig()` is the canonical paper setup.

The device is not a field: it is a constructor argument of `GPFleet`.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass

_GRAPHS = ("path", "cycle", "complete", "random")
_CONSENSUS = ("dac", "exact")
_INDUCING_INITS = ("stride", "random")


@dataclass(frozen=True)
class FleetConfig:
    # -- kernel hyperparameters (linear space, paper convention) ------------
    input_dim: int = 2
    theta0: tuple = (2.0, 0.5, 1.0, 1.0)   # (l_1..l_D, sigma_f, sigma_eps)

    # -- partition / graph topology -----------------------------------------
    num_agents: int = 4                    # paper fleets: 4, 10, 20, 40
    graph: str = "path"                    # path | cycle | complete | random
    graph_p: float = 0.5                   # edge probability (graph="random")
    graph_seed: int = 0

    # -- trainer (registry name) + ADMM parameters --------------------------
    trainer: str = "dec-apx"
    rho: float = 500.0
    kappa: float = 5_000.0
    lipschitz: float = 5_000.0             # L of apx-GP / gapx-GP (eq. 26)
    admm_iters: int = 100                  # paper: s_end = 100
    nested_iters: int = 10                 # c-GP / DEC-c-GP inner GD steps
    nested_lr: float = 1e-5
    fact_steps: int = 200                  # FACT-GP Adam steps
    fact_lr: float = 0.05

    # -- prediction method (registry name) + consensus parameters -----------
    method: str = "rbcm"
    chunk: int = 256                       # engine query-tile size
    dac_iters: int = 200
    jor_iters: int = 500
    dale_iters: int = 2_000
    pm_iters: int = 100
    eta_nn: float = 0.1                    # CBNN threshold (paper eq. 39)
    npae_jitter: float = 1e-6
    jitter: float = 1e-8                   # factorization jitter
    stream_mean: bool = False              # fused rbf_matvec mean path
    cache_cross: bool = False              # NPAE cross-Gram cache

    # -- serving switches ----------------------------------------------------
    sharded: bool = False                  # agent axis over a device mesh
    routed: bool = False                   # CBNN query routing (nn_* only)
    consensus: str = "dac"                 # sharded ring: dac | exact
    max_shard_devices: int | None = None

    # -- online / streaming switches ----------------------------------------
    online: bool = False                   # sliding-window experts
    window: int | None = None              # W (None: window = Ni)

    # -- sparse pseudo-representation experts (core.sparse) -----------------
    sparse_m: int | None = None            # inducing points per agent
    inducing_init: str = "stride"          # stride | random

    def __post_init__(self):
        if self.graph not in _GRAPHS:
            raise ValueError(f"graph must be one of {_GRAPHS}, "
                             f"got {self.graph!r}")
        if self.consensus not in _CONSENSUS:
            raise ValueError(f"consensus must be one of {_CONSENSUS}, "
                             f"got {self.consensus!r}")
        if len(self.theta0) != self.input_dim + 2:
            raise ValueError(
                f"theta0 must have input_dim + 2 = {self.input_dim + 2} "
                f"entries (l_1..l_D, sigma_f, sigma_eps), "
                f"got {len(self.theta0)}")
        if self.inducing_init not in _INDUCING_INITS:
            raise ValueError(
                f"inducing_init must be one of {_INDUCING_INITS}, "
                f"got {self.inducing_init!r}")
        if self.sparse_m is not None and self.sparse_m < 1:
            raise ValueError(f"sparse_m must be a positive inducing count, "
                             f"got {self.sparse_m}")
        # CLI convention writes method names with hyphens ("npae-sparse");
        # engine dispatch keys use underscores — normalize once here
        object.__setattr__(self, "method", self.method.replace("-", "_"))

    def replace(self, **kw) -> "FleetConfig":
        return dataclasses.replace(self, **kw)

    # -- serialization (rides GPFleet.save / load) --------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FleetConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown FleetConfig fields {sorted(unknown)} "
                             f"(config saved by a newer version?)")
        d = dict(d)
        if "theta0" in d:
            d["theta0"] = tuple(d["theta0"])
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "FleetConfig":
        return cls.from_dict(json.loads(s))

