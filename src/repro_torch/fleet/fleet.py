"""GPFleet: the agent-facing facade over the fleet lifecycle.

    cfg = FleetConfig(stream_mean=True)
    fleet = GPFleet(cfg).fit(Xp, yp, train=False)   # factor caching
    mean, var, info = fleet.predict(Xs)             # query-tiled serving

Counterpart of `repro.fleet.fleet.GPFleet` for the replicated serving
path: `fit(train=False)` serves from known hyperparameters (config.theta0
or `log_theta0`), and `predict` dispatches to the PredictionEngine. The
fleet runs on `device` (default: cuda; raises when no card is present and
the caller did not pass device="cpu"). Training, persistence, online
experts and the sharded engine are not ported yet (ROADMAP queue A).
"""
from __future__ import annotations

import torch

from ..core.consensus import (complete_graph, cycle_graph, path_graph,
                              random_connected_graph)
from ..core.gp import pack
from ..core.prediction import FittedExperts, PredictionEngine, fit_experts
from ..device import resolve_device
from .config import FleetConfig
from .registry import TRAINING_ITEM, get_method, validate_config


def _build_graph(cfg: FleetConfig) -> torch.Tensor:
    if cfg.graph == "path":
        return path_graph(cfg.num_agents)
    if cfg.graph == "cycle":
        return cycle_graph(cfg.num_agents)
    if cfg.graph == "complete":
        return complete_graph(cfg.num_agents)
    return random_connected_graph(cfg.num_agents, cfg.graph_p,
                                  seed=cfg.graph_seed)


class GPFleet:
    """Config-driven facade over factor caching and serving."""

    def __init__(self, config: FleetConfig | None = None, *, A=None,
                 device=None):
        cfg = config if config is not None else FleetConfig()
        validate_config(cfg)
        self.device = resolve_device(device)
        self.config = cfg
        self.A = torch.as_tensor(A) if A is not None else _build_graph(cfg)
        if self.A.shape[0] != cfg.num_agents:
            raise ValueError(f"adjacency for {self.A.shape[0]} agents vs "
                             f"config.num_agents={cfg.num_agents}")
        self.log_theta = None          # served hyperparameters (K,)
        self.fitted: FittedExperts | None = None
        self._engine: PredictionEngine | None = None

    @property
    def num_agents(self) -> int:
        return self.config.num_agents

    @property
    def engine(self) -> PredictionEngine:
        """The serving engine (built on first use, dropped on refit)."""
        if self._engine is None:
            if self.fitted is None:
                raise RuntimeError("serving needs a fitted fleet — call "
                                   "fit() first")
            cfg = self.config
            self._engine = PredictionEngine(
                self.fitted, self.A, chunk=cfg.chunk,
                dac_iters=cfg.dac_iters, stream_mean=cfg.stream_mean,
                device=self.device)
        return self._engine

    def fit(self, Xp, yp, *, log_theta0=None,
            train: bool = True) -> "GPFleet":
        """Cache the serving factors of the partitioned data. Returns self.

        Xp (M, Ni, D), yp (M, Ni) as tensors or numpy arrays; they move to
        the fleet's device and keep their dtype. `train=False` serves from
        `log_theta0` (default: config.theta0) — the "true hyperparameters
        known" scenario. Training (`train=True`) is not ported yet.
        """
        if train:
            raise NotImplementedError(
                f"training is not yet ported to repro_torch ({TRAINING_ITEM}"
                f"); serve known hyperparameters with fit(..., train=False)")
        cfg = self.config
        Xp = torch.as_tensor(Xp, device=self.device)
        yp = torch.as_tensor(yp, device=self.device)
        if Xp.shape[0] != cfg.num_agents:
            raise ValueError(
                f"data for {Xp.shape[0]} agents vs config.num_agents="
                f"{cfg.num_agents}; set FleetConfig(num_agents=...) to the "
                f"fleet you partitioned")
        if Xp.shape[-1] != cfg.input_dim:
            raise ValueError(f"data input_dim {Xp.shape[-1]} vs config."
                             f"input_dim={cfg.input_dim}")
        if log_theta0 is not None:
            lt = torch.as_tensor(log_theta0, dtype=Xp.dtype,
                                 device=self.device)
        else:
            lt = pack(list(cfg.theta0[:-2]), cfg.theta0[-2], cfg.theta0[-1],
                      dtype=Xp.dtype, device=self.device)
        self.log_theta = lt
        self.fitted = fit_experts(lt, Xp, yp, jitter=cfg.jitter)
        self._engine = None
        return self

    def predict(self, Xs, method: str | None = None):
        """Serve one query batch -> (mean (Nt,), var (Nt,), info).

        `method` overrides config.method for this call; `cen_*`
        centralized references pass through to the engine."""
        method = (method if method is not None
                  else self.config.method).replace("-", "_")
        get_method(method[4:] if method.startswith("cen_") else method)
        return self.engine.predict(method, Xs)
