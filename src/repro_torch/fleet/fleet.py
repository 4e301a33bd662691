"""GPFleet: the agent-facing facade over the fleet lifecycle.

    cfg = FleetConfig(stream_mean=True)
    fleet = GPFleet(cfg).fit(Xp, yp)        # train (dec-apx), cache factors
    mean, var, info = fleet.predict(Xs)     # query-tiled serving

Counterpart of `repro.fleet.fleet.GPFleet` for the replicated path:
`fit` trains the hyperparameters with the configured trainer (TRAINERS)
and caches the factors at the trained theta, or with `train=False` serves
known hyperparameters; `predict` dispatches to the PredictionEngine. With
FleetConfig(online=True) the factors are sliding windows (core.online):

    fleet = GPFleet(FleetConfig(online=True, window=W)).fit(Xp, yp)
    fleet.observe(xs, ys)       # O(W^2) rank-1 updates, swapped into the
    fleet.predict(Xs)           # engine in place (swap_experts)
    fleet.drift(iters=5)        # retrain on the live windows, refit, swap
    fleet.join(X_new, y_new); fleet.leave(1)   # membership: rewire

With FleetConfig(sparse_m=m) the factors are sparse pseudo-representation
experts (core.sparse, m inducing points per agent, fitted through the
rbf_gram kernel), served by the DAC family and `npae_sparse`; the
`fact-sparse` trainer's optimized inducing inputs are the ones served.

The grBCM communication dataset D_c and the augmented datasets D_{+i}
(paper §2.3.2) are built in `fit` only when something consumes them: a
`gapx`/`dec-gapx` trainer that runs, or a grbcm-family method, which then
serves from augmented experts and a one-agent communication expert (dense
or sparse, as the fleet is).

The fleet runs on `device` (default: cuda; raises when no card is present
and the caller did not pass device="cpu"). Persistence, training traces
and the sharded engine are not ported yet (ROADMAP queue A).
"""
from __future__ import annotations

import torch

from ..core.consensus import (complete_graph, cycle_graph, path_graph,
                              random_connected_graph)
from ..core.gp import augment, communication_dataset, pack
from ..core.online import (OnlineExperts, from_batch, join, leave,
                           observe_fleet, refit)
from ..core.prediction import FittedExperts, PredictionEngine, fit_experts
from ..core.sparse import SparseExperts, fit_sparse_experts, select_inducing
from ..device import resolve_device
from .config import FleetConfig
from .registry import get_method, get_trainer, validate_config


def _tensor(x, dtype, device) -> torch.Tensor:
    """A tensor moved to `device` and `dtype`, or a copy of an array (the
    reference's results arrive as read-only numpy arrays)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(x, dtype=dtype, device=device)


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
        self.thetas = None             # per-agent hyperparameters (M, K)
        self.train_info = {}           # the trainer's info dict
        self.fitted: FittedExperts | SparseExperts | None = None
        self.fitted_aug: FittedExperts | SparseExperts | None = None
        self.fitted_comm: FittedExperts | SparseExperts | None = None
        self._comm_data = None         # (Xc, yc, Xa, ya) when built
        self._online_state: OnlineExperts | None = None
        self._engine: PredictionEngine | None = None

    @property
    def num_agents(self) -> int:
        return self.config.num_agents

    @property
    def window_counts(self):
        """(M,) real observations per agent's sliding window, or None for
        batch (non-online) fleets."""
        return None if self._online_state is None \
            else self._online_state.count

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
                dac_iters=cfg.dac_iters, jor_iters=cfg.jor_iters,
                dale_iters=cfg.dale_iters, pm_iters=cfg.pm_iters,
                eta_nn=cfg.eta_nn, npae_jitter=cfg.npae_jitter,
                fitted_aug=self.fitted_aug, fitted_comm=self.fitted_comm,
                stream_mean=cfg.stream_mean, device=self.device)
        return self._engine

    def _needs_comm_data(self, train: bool) -> bool:
        """The communication/augmented datasets are built only when
        consumed: by an augmented-data trainer that will actually run, or
        by a grbcm-family serving method."""
        return ((train and get_trainer(self.config.trainer)
                 .needs_augmented_data)
                or get_method(self.config.method).needs_augmented_data)

    def fit(self, Xp, yp, *, generator=None, comm_data=None,
            log_theta0=None, thetas=None, grad_fn=None, train: bool = True,
            trace=None) -> "GPFleet":
        """Train the hyperparameters (trainer registry) and cache the
        serving factors. Returns self.

        Xp (M, Ni, D), yp (M, Ni) as tensors or numpy arrays; they move to
        the fleet's device and keep their dtype. Training starts every agent
        at `log_theta0` (default: config.theta0) and runs on the fleet's
        device; `grad_fn` is the trainers' local-gradient hook
        (core.training.make_local_grad). The served theta is the trainer's
        (the agents' mean for the decentralized ones).

        `train=False` serves `log_theta0` as it is: the "true
        hyperparameters known" scenario, or hyperparameters trained
        elsewhere (the reference's `log_theta` and per-agent `thetas`, as
        numpy arrays; `thetas` is read only here). `trace` (the
        reference's TraceRecorder hook) is not yet ported.

        When the trainer or method needs the grBCM communication dataset,
        it is drawn from `generator` (a torch.Generator; None takes torch's
        default one), or taken as given from `comm_data` = (Xc, yc), e.g.
        the reference's draw as numpy arrays.
        """
        if trace is not None:
            raise NotImplementedError(
                "fit(trace=...) is not yet ported to repro_torch (ROADMAP "
                "queue A item 4, obs)")
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
            lt0 = _tensor(log_theta0, Xp.dtype, self.device)
        else:
            lt0 = pack(list(cfg.theta0[:-2]), cfg.theta0[-2],
                       cfg.theta0[-1], dtype=Xp.dtype, device=self.device)
        self._comm_data = None
        if self._needs_comm_data(train):
            if comm_data is not None:
                Xc, yc = (_tensor(a, Xp.dtype, self.device)
                          for a in comm_data)
            else:
                Xc, yc = communication_dataset(generator, Xp, yp)
            self._comm_data = (Xc, yc, *augment(Xp, yp, Xc, yc))
        if train:
            spec = get_trainer(cfg.trainer)
            Xt, yt = (self._comm_data[2:] if spec.needs_augmented_data
                      else (Xp, yp))
            self.log_theta, self.thetas, self.train_info = spec.run(
                cfg, lt0, Xt, yt, self.A, grad_fn=grad_fn)
        else:
            self.log_theta = lt0
            self.thetas = (lt0.expand(cfg.num_agents, lt0.shape[0])
                           if thetas is None
                           else _tensor(thetas, Xp.dtype, self.device))
            self.train_info = {}
        if cfg.online:
            self._online_state = from_batch(self.log_theta, Xp, yp,
                                            window=cfg.window,
                                            jitter=cfg.jitter)
            self.fitted = self._online_state.to_fitted()
        elif cfg.sparse_m is not None:
            # the fact-sparse trainer optimized the inducing sets: serve
            # from the Z the bound was tightened over
            self.fitted = self._fit_sparse(self.log_theta, Xp, yp,
                                           self.train_info.get("Z"))
        else:
            self.fitted = fit_experts(self.log_theta, Xp, yp,
                                      jitter=cfg.jitter,
                                      cache_cross=cfg.cache_cross)
        self.fitted_aug = self.fitted_comm = None
        if get_method(cfg.method).needs_augmented_data:
            Xc, yc, Xa, ya = self._comm_data
            if cfg.sparse_m is not None:
                self.fitted_aug = self._fit_sparse(self.log_theta, Xa, ya)
                self.fitted_comm = self._fit_sparse(self.log_theta,
                                                    Xc[None], yc[None])
            else:
                self.fitted_aug = fit_experts(self.log_theta, Xa, ya,
                                              jitter=cfg.jitter)
                self.fitted_comm = fit_experts(self.log_theta, Xc[None],
                                               yc[None], jitter=cfg.jitter)
        self._engine = None
        return self

    def _fit_sparse(self, lt, Xp, yp, Z=None) -> SparseExperts:
        cfg = self.config
        if Z is None:
            Z = select_inducing(Xp, cfg.sparse_m, cfg.inducing_init)
        return fit_sparse_experts(lt, Xp, yp, Z, jitter=cfg.jitter)

    def predict(self, Xs, method: str | None = None):
        """Serve one query batch -> (mean (Nt,), var (Nt,), info).

        `method` overrides config.method for this call; `cen_*`
        centralized references pass through to the engine."""
        cfg = self.config
        method = (method if method is not None
                  else cfg.method).replace("-", "_")
        spec = get_method(method[4:] if method.startswith("cen_")
                          else method)
        if not method.startswith("cen_") and (
                (cfg.sparse_m is not None and not spec.sparse)
                or (spec.family == "sparse" and cfg.sparse_m is None)):
            validate_config(cfg.replace(method=method))   # a clear error
        if spec.needs_augmented_data and self.fitted_aug is None:
            raise ValueError(
                f"method {method!r} needs the grBCM augmented/"
                f"communication experts; fit with a grbcm method "
                f"configured (FleetConfig(method=...)) so they are built")
        return self.engine.predict(method, Xs)

    # -- streaming / membership ----------------------------------------------

    def _require_online(self, verb: str) -> OnlineExperts:
        if self.fitted is None:
            raise RuntimeError(f"{verb} needs a fitted fleet — call fit() "
                               f"first")
        if self._online_state is None:
            raise RuntimeError(
                f"{verb} needs a streaming fleet — construct with "
                f"FleetConfig(online=True) before fit()")
        return self._online_state

    def _swap(self, state: OnlineExperts) -> None:
        self._online_state = state
        self.fitted = state.to_fitted()
        if self._engine is not None:
            self._engine.swap_experts(self.fitted)

    def observe(self, xs, ys) -> "GPFleet":
        """Ingest one observation per agent (xs (M, D), ys (M,)) through the
        O(W^2) rank-1 factor updates and swap the engine's served factors
        in place. Returns self."""
        state = self._require_online("observe")
        dt = state.Xw.dtype
        self._swap(observe_fleet(state, _tensor(xs, dt, self.device),
                                 _tensor(ys, dt, self.device)))
        return self

    def drift(self, *, grad_fn=None, iters: int | None = None) -> dict:
        """Re-run the configured trainer on the LIVE sliding windows and
        swap the retrained factors into the serving engine — the
        drift-adaptation loop: stream with `observe`, periodically `drift`
        so the hyperparameters track the data the windows hold now.

        Training uses the filled window prefix shared by every agent
        (`min(window_counts)` observations; sentinel slots never enter the
        likelihood), warm-starts from the current theta, and `iters` caps
        this epoch's ADMM budget (default config.admm_iters). The windows
        are refit at the new theta and swapped in place (`swap_experts`).
        Returns the trainer's info dict."""
        state = self._require_online("drift")
        n = int(state.count.min())
        if n < 2:
            raise RuntimeError(
                f"drift needs >= 2 observations in every agent's window "
                f"(min count is {n}) — stream more data with observe() "
                f"first")
        spec = get_trainer(self.config.trainer)
        if spec.needs_augmented_data:
            raise ValueError(
                f"trainer {self.config.trainer!r} needs augmented/"
                f"communication datasets, which sliding windows do not "
                f"carry — streaming fleets drift with a plain-data trainer")
        cfg = self.config if iters is None \
            else self.config.replace(admm_iters=int(iters))
        self.log_theta, self.thetas, info = spec.run(
            cfg, self.log_theta, state.Xw[:, :n], state.yw[:, :n], self.A,
            grad_fn=grad_fn)
        self._swap(refit(state._replace(
            log_theta=self.log_theta.to(state.log_theta.dtype))))
        return info

    def join(self, X_new=None, y_new=None, neighbors=None) -> "GPFleet":
        """One agent joins the streaming fleet (window seeded from X_new /
        y_new); the consensus graph is attached and the engine rewired on
        the new M."""
        state = self._require_online("join")
        self._online_state, self.A = join(state, self.A, X_new, y_new,
                                          neighbors=neighbors)
        self._after_membership_change()
        return self

    def leave(self, agent: int) -> "GPFleet":
        """Agent `agent` leaves; former neighbors are re-chained so the
        consensus graph stays connected."""
        state = self._require_online("leave")
        self._online_state, self.A = leave(state, self.A, agent)
        self._after_membership_change()
        return self

    def _after_membership_change(self):
        self.fitted = self._online_state.to_fitted()
        self.config = self.config.replace(
            num_agents=self._online_state.num_agents)
        if self._engine is not None:
            self._engine.rewire(self.A, fitted=self.fitted)
