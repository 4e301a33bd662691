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

Persistence writes the reference's checkpoint format (checkpoint.io:
the same npz leaf keys, manifest.json and fleet.json), so a fleet saved
by either package loads into the other and serves equal predictions:

    fleet.save("ckpt/")                     # factors + config + graph
    fleet = GPFleet.load("ckpt/")           # serve WITHOUT refitting,
    mean2, var2, _ = fleet.predict(Xs)      # bit for bit the same

`fit(trace=TraceRecorder())` records the trainer's per-iteration
diagnostics, and `metrics()` is the `obs` default registry's snapshot
with a block for this fleet.

Chaos and serving, as in the reference:

    mean, var, info = fleet.predict(Xs, fault_plan=plan,
                                    allow_degraded=True)   # chaos.FaultPlan
    fleet.health()                  # graph, degraded/diverged totals
    with fleet.to_server(batch=1024) as srv:   # launch.scheduler
        mean, var = srv.submit(Xq).result()

A degraded answer (dropped agents, a partition, scrubbed payloads) is
returned only under `allow_degraded=True`, else raised as FleetDegraded
with the answer attached; `slot_geometry` gives a scheduler its slot
ladder (the engine chunk up to the method's `max_slot`).

Agent-sharded serving, as in the reference:

    fleet = GPFleet(FleetConfig(sharded=True)).fit(Xp, yp)  # ShardedEngine
    fleet.shard(mesh=make_agent_mesh(4, devices=("cuda:0",) * 4),
                routed=True)        # in place; nn_* then route queries

The mesh (`launch.mesh.AgentMesh`) defaults to the visible cards, or to
the fleet's device alone on the CPU; the `dec-apx-sharded` trainer runs
on it too.

The fleet runs on `device` (default: cuda; raises when no card is present
and the caller did not pass device="cpu").
"""
from __future__ import annotations

import json
import os

import torch

from ..checkpoint.io import (LeafSpec, leaf_keys, restore, save_checkpoint,
                             tree_unflatten)

from ..core.consensus import (complete_graph, connected_components,
                              cycle_graph, is_connected, path_graph,
                              random_connected_graph)
from ..core.gp import augment, communication_dataset, pack
from ..core.online import (OnlineExperts, from_batch, join, leave,
                           observe_fleet, refit)
from ..core.prediction import (FittedExperts, PredictionEngine,
                               ShardedEngine, fit_experts)
from ..core.sparse import SparseExperts, fit_sparse_experts, select_inducing
from ..device import resolve_device
from ..launch.mesh import mesh_for
from ..launch.scheduler import ServingScheduler
from ..obs import default_registry
from ..obs.tracing import span
from .config import FleetConfig
from .registry import get_method, get_trainer, validate_config


def _tensor(x, dtype, device) -> torch.Tensor:
    """A tensor moved to `device` and `dtype`, or a copy of an array (the
    reference's results arrive as read-only numpy arrays)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(x, dtype=dtype, device=device)


_FLEET_MANIFEST = "fleet.json"
_FORMAT_VERSION = 1


class FleetDegraded(RuntimeError):
    """A prediction came back in DEGRADED mode (dropped agents, network
    partition, scrubbed payloads) and the caller did not opt in with
    `predict(..., allow_degraded=True)`. The degradation census is on
    `.info`; the (finite, flagged) result itself is on `.result`."""

    def __init__(self, message: str, info: dict | None = None,
                 result=None):
        super().__init__(message)
        self.info = info or {}
        self.result = result


def _contiguous(experts):
    """The experts with every tensor row-major contiguous. A checkpoint
    stores arrays in C order, so a fleet serves from C-order factors
    from the start (torch's Cholesky factors are column-major) and gives
    the same bits after `load` as before `save`."""
    if experts is None:
        return None
    return type(experts)(*(None if t is None else t.contiguous()
                           for t in experts))


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
                 mesh=None, device=None):
        cfg = config if config is not None else FleetConfig()
        validate_config(cfg)
        self.device = resolve_device(device)
        self.config = cfg
        self.mesh = mesh               # launch.mesh.AgentMesh or None
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
        self._last_degraded = None     # census of the last degraded predict

    @property
    def num_agents(self) -> int:
        return self.config.num_agents

    @property
    def is_fitted(self) -> bool:
        return self.fitted is not None

    @property
    def jit_cache_misses(self) -> int:
        """The serving engine's count of distinct (method, query geometry)
        pairs served (the reference's trace count); 0 before the first
        serve."""
        return 0 if self._engine is None else self._engine.jit_cache_misses

    @property
    def window_counts(self):
        """(M,) real observations per agent's sliding window, or None for
        batch (non-online) fleets."""
        return None if self._online_state is None \
            else self._online_state.count

    @property
    def engine(self) -> PredictionEngine | ShardedEngine:
        """The serving engine (built on first use, dropped on refit and on
        shard)."""
        if self._engine is None:
            if self.fitted is None:
                raise RuntimeError("serving needs a fitted fleet — call "
                                   "fit() first")
            self._engine = self._build_engine()
        return self._engine

    def _build_engine(self):
        cfg = self.config
        if cfg.sharded:
            if self.mesh is None:
                self.mesh = mesh_for(cfg.num_agents, self.device,
                                     max_devices=cfg.max_shard_devices)
            return ShardedEngine(self.fitted, self.mesh, chunk=cfg.chunk,
                                 dac_iters=cfg.dac_iters, eta_nn=cfg.eta_nn,
                                 consensus=cfg.consensus,
                                 npae_jitter=cfg.npae_jitter,
                                 fitted_aug=self.fitted_aug,
                                 fitted_comm=self.fitted_comm,
                                 stream_mean=cfg.stream_mean)
        return PredictionEngine(
            self.fitted, self.A, chunk=cfg.chunk, dac_iters=cfg.dac_iters,
            jor_iters=cfg.jor_iters, dale_iters=cfg.dale_iters,
            pm_iters=cfg.pm_iters, eta_nn=cfg.eta_nn,
            npae_jitter=cfg.npae_jitter, fitted_aug=self.fitted_aug,
            fitted_comm=self.fitted_comm, stream_mean=cfg.stream_mean,
            device=self.device)

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
        numpy arrays; `thetas` is read only here). `trace` (an
        `obs.TraceRecorder`) switches the trainer's diagnostics on
        (`diag=True`: per-iteration NLL, primal/dual residuals, theta
        trajectory, stacked on the device) and records the info dict on
        the recorder after the fit; the trained theta is the same.

        When the trainer or method needs the grBCM communication dataset,
        it is drawn from `generator` (a torch.Generator; None takes torch's
        default one), or taken as given from `comm_data` = (Xc, yc), e.g.
        the reference's draw as numpy arrays.
        """
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
                cfg, lt0, Xt, yt, self.A, mesh=self.mesh, grad_fn=grad_fn,
                diag=trace is not None)
            if trace is not None:
                trace.record(cfg.trainer, self.train_info,
                             num_agents=cfg.num_agents, method=cfg.method)
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
            self.fitted = _contiguous(fit_experts(
                self.log_theta, Xp, yp, jitter=cfg.jitter,
                cache_cross=cfg.cache_cross))
        self.fitted_aug = self.fitted_comm = None
        if get_method(cfg.method).needs_augmented_data:
            Xc, yc, Xa, ya = self._comm_data
            if cfg.sparse_m is not None:
                self.fitted_aug = self._fit_sparse(self.log_theta, Xa, ya)
                self.fitted_comm = self._fit_sparse(self.log_theta,
                                                    Xc[None], yc[None])
            else:
                self.fitted_aug = _contiguous(fit_experts(
                    self.log_theta, Xa, ya, jitter=cfg.jitter))
                self.fitted_comm = _contiguous(fit_experts(
                    self.log_theta, Xc[None], yc[None], jitter=cfg.jitter))
        self._engine = None
        return self

    def _fit_sparse(self, lt, Xp, yp, Z=None) -> SparseExperts:
        cfg = self.config
        if Z is None:
            Z = select_inducing(Xp, cfg.sparse_m, cfg.inducing_init)
        return _contiguous(fit_sparse_experts(lt, Xp, yp, Z,
                                              jitter=cfg.jitter))

    def predict(self, Xs, method: str | None = None, *, fault_plan=None,
                allow_degraded: bool = False):
        """Serve one query batch -> (mean (Nt,), var (Nt,), info).

        `method` overrides config.method for this call (under the same
        capability rules); `cen_*` centralized references pass through to
        the replicated engine. A routed fleet serves its nn_* methods by
        CBNN query routing (`ShardedEngine.predict_routed`).

        `fault_plan` (chaos.FaultPlan) injects the plan's consensus faults:
        the engine serves over the surviving subgraph and flags the result
        info["degraded"]=True (see PredictionEngine.predict). A degraded
        result is returned only under `allow_degraded=True`; otherwise it
        is raised inside a FleetDegraded, so a caller never mistakes a
        partial-fleet answer for a healthy one. Divergence raises
        ConsensusDiverged either way; consensus faults serve on the
        replicated engine only."""
        cfg = self.config
        method = (method if method is not None
                  else cfg.method).replace("-", "_")
        cen = method.startswith("cen_")
        spec = get_method(method[4:] if cen else method)
        if fault_plan is not None and not fault_plan.consensus_free \
                and cfg.sharded:
            raise ValueError(
                "fault plans with consensus faults serve on the replicated "
                "engine only (the sharded consensus runs on the ring of "
                "members, which has no degraded mode)")
        if cen and cfg.sharded:
            raise ValueError("centralized cen_* references serve on the "
                             "replicated engine only")
        if not cen and (
                (cfg.sharded and not spec.shardable)
                or (cfg.sparse_m is not None and not spec.sparse)
                or (spec.family == "sparse" and cfg.sparse_m is None)):
            validate_config(cfg.replace(method=method))   # a clear error
        if spec.needs_augmented_data and self.fitted_aug is None:
            raise ValueError(
                f"method {method!r} needs the grBCM augmented/"
                f"communication experts; fit with a grbcm method "
                f"configured (FleetConfig(method=...)) so they are built")
        if cfg.routed and method.startswith("nn_"):
            return self.engine.predict_routed(method, Xs)
        if fault_plan is None or fault_plan.consensus_free:
            # a consensus-free plan (stragglers, injected failures) changes
            # no value: the exact path, on either engine
            return self.engine.predict(method, Xs)
        mean, var, info = self.engine.predict(method, Xs,
                                              fault_plan=fault_plan)
        if info.get("degraded"):
            self._last_degraded = {k: info[k] for k in
                                   ("alive_agents", "excluded_agents",
                                    "n_components", "scrubbed_agents")}
            if not allow_degraded:
                raise FleetDegraded(
                    f"prediction served in degraded mode "
                    f"({info['alive_agents']}/{self.num_agents} agents "
                    f"alive, {info['scrubbed_agents']} scrubbed) — pass "
                    f"allow_degraded=True to accept flagged partial-fleet "
                    f"results", info=info, result=(mean, var))
        return mean, var, info

    def shard(self, mesh=None, *, routed: bool | None = None) -> "GPFleet":
        """Move serving onto the agent-sharded engine (in place): the
        config's capability rules are checked first; `routed` switches
        CBNN query routing on or off at the same time. Returns self."""
        cfg = self.config.replace(
            sharded=True,
            routed=self.config.routed if routed is None else routed)
        validate_config(cfg)
        self.config = cfg
        if mesh is not None:
            self.mesh = mesh
        self._engine = None
        return self

    def slot_geometry(self, method: str | None = None) -> tuple[int, int]:
        """(align, max_slot) for serving schedulers packing this fleet:
        slots are multiples of the engine chunk up to the method registry's
        `max_slot` (the NPAE family's per-query (M, M) solves cap out
        earlier than the flat-tiling DAC family)."""
        method = method if method is not None else self.config.method
        base = method[4:] if method.startswith("cen_") else method
        return int(self.config.chunk), int(get_method(base).max_slot)

    def health(self) -> dict:
        """Point-in-time fleet health: shape, consensus-graph connectivity,
        the degraded/diverged serving totals (the engine's `obs`
        counters; the registry is process-wide, so every engine's) and the
        census of the last degraded prediction. Host-side graph analysis
        only, no device work: safe to poll from a watchdog."""
        labels = connected_components(self.A)
        h = {
            "num_agents": self.num_agents,
            "is_fitted": self.is_fitted,
            "sharded": self.config.sharded,
            "graph_connected": bool(is_connected(self.A)),
            "graph_components": int(len(set(labels.tolist()))),
            "degraded_predictions": 0.0,
            "diverged_predictions": 0.0,
            "last_degraded": self._last_degraded,
        }
        eng = self._engine
        if eng is not None and hasattr(eng, "_degraded_total"):
            h["degraded_predictions"] = sum(
                v for _, v in eng._degraded_total.collect())
            h["diverged_predictions"] = sum(
                v for _, v in eng._diverged_total.collect())
        return h

    def to_server(self, batch: int = 256, *, max_wait_ms: float = 2.0,
                  method: str | None = None, queue_depth: int = 1024,
                  continuous: bool = True, warm: bool = True,
                  admission: str = "block", deadline_policy: str = "drop"
                  ) -> ServingScheduler:
        """A started one-tenant `ServingScheduler` over this fleet: submit
        (Nq, D) requests, get Futures of (mean, var); use as a context
        manager to drain on exit. `continuous=True` serves the slot ladder
        up to `batch` rows; `continuous=False` the one fixed geometry of
        the v1 FrontDoor. `warm=True` serves every slot once first, so the
        request path meets no new geometry."""
        if self.fitted is None:
            raise RuntimeError("to_server needs a fitted fleet — call fit() "
                               "first")
        sched = ServingScheduler(max_wait_ms=max_wait_ms)
        sched.add_fleet("default", self, method=method, max_slot=int(batch),
                        continuous=continuous, queue_depth=queue_depth,
                        admission=admission, deadline_policy=deadline_policy,
                        warm=warm)
        return sched

    def metrics(self) -> dict:
        """Observability snapshot: the process-wide `obs` default registry
        (counters, gauges, histograms; the engine's trace counter writes
        there) plus a `fleet` block describing THIS fleet, with the
        reference's keys. `obs.prometheus_text()` renders the same
        registry in the Prometheus text format."""
        snap = default_registry().snapshot()
        snap["fleet"] = {
            "num_agents": self.config.num_agents,
            "trainer": self.config.trainer,
            "method": self.config.method,
            "sharded": self.config.sharded,
            "is_fitted": self.is_fitted,
            "jit_cache_misses": self.jit_cache_misses,
        }
        return snap

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
        with span("online.observe"):
            state = observe_fleet(state, _tensor(xs, dt, self.device),
                                  _tensor(ys, dt, self.device))
            with span("engine.swap"):
                self._swap(state)
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
            mesh=self.mesh, grad_fn=grad_fn)
        self._swap(refit(state._replace(
            log_theta=self.log_theta.to(state.log_theta.dtype))))
        return info

    def join(self, X_new=None, y_new=None, neighbors=None) -> "GPFleet":
        """One agent joins the streaming fleet (window seeded from X_new /
        y_new); the consensus graph is attached and the engine rewired on
        the new M (on the replicated engine: sharded blocks are fixed at
        construction)."""
        state = self._require_online("join")
        self._refuse_sharded_membership()
        self._online_state, self.A = join(state, self.A, X_new, y_new,
                                          neighbors=neighbors)
        self._after_membership_change()
        return self

    def leave(self, agent: int) -> "GPFleet":
        """Agent `agent` leaves; former neighbors are re-chained so the
        consensus graph stays connected."""
        state = self._require_online("leave")
        self._refuse_sharded_membership()
        self._online_state, self.A = leave(state, self.A, agent)
        self._after_membership_change()
        return self

    def _refuse_sharded_membership(self):
        if self.config.sharded:
            raise ValueError("membership changes serve on the replicated "
                             "engine (ShardedEngine shards are fixed at "
                             "construction)")

    def _after_membership_change(self):
        self.fitted = self._online_state.to_fitted()
        self.config = self.config.replace(
            num_agents=self._online_state.num_agents)
        if self._engine is not None:
            self._engine.rewire(self.A, fitted=self.fitted)

    # -- persistence ---------------------------------------------------------

    def _state_tree(self) -> dict:
        tree = {"A": self.A, "log_theta": self.log_theta,
                "thetas": self.thetas, "fitted": self.fitted}
        if self.fitted_aug is not None:
            tree["fitted_aug"] = self.fitted_aug
        if self.fitted_comm is not None:
            tree["fitted_comm"] = self.fitted_comm
        if self._online_state is not None:
            tree["count"] = self._online_state.count
            tree["jitter"] = self._online_state.jitter
        return tree

    def save(self, ckpt_dir: str, step: int = 0) -> str:
        """Persist the fitted fleet: factors + config + consensus graph (+
        the online window state) in the reference's format. `load` serves
        bit-identical predictions from it without refitting."""
        if self.fitted is None:
            raise RuntimeError("save needs a fitted fleet — call fit() or "
                               "load() first")
        path = save_checkpoint(ckpt_dir, step, self._state_tree())
        # the leaf shapes and dtypes are in checkpoint.io's manifest.json;
        # fleet.json adds the config and which optional components exist
        manifest = {
            "format": _FORMAT_VERSION,
            "config": self.config.to_dict(),
            "step": step,
            "components": {
                "fitted_aug": self.fitted_aug is not None,
                "fitted_comm": self.fitted_comm is not None,
                "fitted_kcross": self.fitted.Kcross is not None,
                "aug_kcross": (self.fitted_aug is not None
                               and self.fitted_aug.Kcross is not None),
                "online": self._online_state is not None,
                "sparse": isinstance(self.fitted, SparseExperts),
                "aug_sparse": isinstance(self.fitted_aug, SparseExperts),
                "comm_sparse": isinstance(self.fitted_comm, SparseExperts),
            },
        }
        # fleet.json is load()'s entry point: written LAST, by temp file +
        # rename, so a crash mid-save never leaves it over fresh arrays
        mpath = os.path.join(ckpt_dir, _FLEET_MANIFEST)
        tmp = mpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, mpath)
        return path

    @staticmethod
    def _template(ckpt_dir: str, manifest: dict) -> dict:
        """LeafSpec tree of the saved state, what `restore` checks the
        stored leaves against: the structure from fleet.json's
        components, the shapes and dtypes from manifest.json."""
        comp = manifest["components"]
        with open(os.path.join(ckpt_dir, "manifest.json")) as f:
            io_manifest = json.load(f)
        if io_manifest.get("step") != manifest["step"]:
            raise ValueError(
                f"checkpoint manifests disagree: fleet.json is for step "
                f"{manifest['step']} but manifest.json describes step "
                f"{io_manifest.get('step')} (mixed checkpoint directory?)")

        def experts(sparse: bool, kcross: bool):
            if sparse:
                return SparseExperts(0, 0, 0, 0, 0, 0)
            return FittedExperts(0, 0, 0, 0, 0, 0 if kcross else None)

        tree = {"A": 0, "log_theta": 0, "thetas": 0,
                "fitted": experts(comp.get("sparse", False),
                                  comp["fitted_kcross"])}
        if comp["fitted_aug"]:
            tree["fitted_aug"] = experts(comp.get("aug_sparse", False),
                                         comp["aug_kcross"])
        if comp["fitted_comm"]:
            tree["fitted_comm"] = experts(comp.get("comm_sparse", False),
                                          False)
        if comp["online"]:
            tree["count"] = tree["jitter"] = 0
        specs = io_manifest["leaves"]
        leaves = []
        for key in leaf_keys(tree):
            if key not in specs:
                raise ValueError(f"checkpoint manifest is missing leaf "
                                 f"{key!r} (corrupted or truncated "
                                 f"checkpoint?)")
            leaves.append(LeafSpec(specs[key]["shape"],
                                   specs[key]["dtype"]))
        return tree_unflatten(tree, leaves)

    @classmethod
    def load(cls, ckpt_dir: str, *, mesh=None,
             config: FleetConfig | None = None, device=None) -> "GPFleet":
        """Reconstruct a fitted fleet from a `save()` of either package
        onto `device` (default: cuda): no refitting, the served
        predictions are the saving fleet's. `config` overrides the saved
        config (e.g. sharded=True to serve a replicated-saved fleet on
        `mesh`) and is validated like any other."""
        mpath = os.path.join(ckpt_dir, _FLEET_MANIFEST)
        if not os.path.exists(mpath):
            raise FileNotFoundError(
                f"{mpath!r} not found — not a GPFleet.save() checkpoint")
        with open(mpath) as f:
            manifest = json.load(f)
        if manifest.get("format", 0) > _FORMAT_VERSION:
            raise ValueError(
                f"fleet checkpoint format {manifest['format']} is newer "
                f"than this code ({_FORMAT_VERSION})")
        saved_cfg = FleetConfig.from_dict(manifest["config"])
        cfg = config if config is not None else saved_cfg
        dev = resolve_device(device)
        tree = restore(ckpt_dir, cls._template(ckpt_dir, manifest),
                       step=manifest["step"], device=dev)
        fleet = cls(cfg, A=tree["A"].cpu(), mesh=mesh, device=dev)
        fleet.log_theta = tree["log_theta"]
        fleet.thetas = tree["thetas"]
        fleet.fitted = tree["fitted"]
        fleet.fitted_aug = tree.get("fitted_aug")
        fleet.fitted_comm = tree.get("fitted_comm")
        if manifest["components"]["online"]:
            f = fleet.fitted
            fleet._online_state = OnlineExperts(
                f.log_theta, f.Xp, f.yp, f.L, f.alpha, tree["count"],
                tree["jitter"])
        if (get_method(cfg.method).needs_augmented_data
                and fleet.fitted_aug is None):
            raise ValueError(
                f"checkpoint has no augmented/communication experts but "
                f"method {cfg.method!r} needs them; refit with the grbcm "
                f"method configured")
        return fleet
