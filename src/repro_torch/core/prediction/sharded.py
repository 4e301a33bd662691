"""Agent-sharded serving: the fleet distributed over an agent mesh, with
CBNN query routing (paper §5.2, eq. 39) as a serving-time throughput lever.

Counterpart of `repro.core.prediction.sharded`. `PredictionEngine` holds
every agent on one device. This module splits the experts' agent axis
into contiguous blocks, one per member of a `launch.mesh.AgentMesh`, and
runs the DAC family (Algs. 5-9 and their CBNN nn_* variants, Algs. 13-17)
member by member:

  per-agent moments  — each member computes `local_moments_cached` /
                       `cbnn_scores_cached` for its OWN block of M/ndev
                       agents on its own device (with `stream_mean`, one
                       rbf_matvec launch per tile per member and expert
                       set).
  cross-agent sums   — the three PoE/BCM consensus payloads (eq. 12-17)
                       are reduced over the ring of members with the same
                       neighbour-only messages as training's
                       `dec_apx_gp_sharded_step`: `dac_sharded` (paper eq.
                       35 on the ring; default) or the exact finite
                       `ring_allsum` (`consensus="exact"`).
  CBNN masks         — scores are computed member-locally; the >= 1-agent
                       guarantee needs one global number per query (the
                       max score), closed with an exact `ring_allmax`.

The reference runs one program on every device and leaves the replicated
result on each; here one process drives the members in turn and reads the
result out on member 0 (the members' copies are averaged there, the
reference's pmean).

Two serving modes:

  `ShardedEngine.predict(method, Xs)` — full-fleet consensus, equal to the
  replicated `PredictionEngine` once both consensus protocols converged.

  `ShardedEngine.predict_routed(method, Xs)` — CBNN query routing (nn_*
  methods): each query is dispatched (host-side, by nearest agent
  centroid) to the single member holding its most-correlated experts and
  served from that block alone — no cross-member messages, Nt/ndev queries
  of work per member. It equals the full nn_* aggregate whenever the
  thresholded participant set lives inside the routed block; info carries
  per-query participant counts so callers can audit.

The dense NPAE family (Algs. 10-12, 18) needs per-query (M, M) solves over
cross-agent Gram terms and stays on the replicated engine; `ShardedEngine`
rejects it. Its low-rank counterpart `npae_sparse` does shard: each member
computes its block's (m, q) Nystrom factors, `ring_allgather` exchanges
them exactly in ndev - 1 hops, and the full cross-covariance and the NPAE
solve are the replicated engine's (`cross_lowrank` + `aggregation.npae`).
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ...obs import default_registry
from ..consensus.dac import (dac_sharded, dac_sharded_residual,
                             ring_allgather, ring_allmax, ring_allsum)
from ..sparse import (SparseExperts, cross_lowrank, sparse_moments_cached,
                      sparse_npae_factors, sparse_scores)
from .aggregation import npae
from .cbnn import _mask_from_scores, cbnn_scores_cached
from .decentralized import (_grbcm_beta, _grbcm_posterior, _poe_beta,
                            _poe_posterior, _poe_summands)
from .engine import FittedExperts, map_query_tiles
from .local import local_moments_cached

_BETA_MODE = {"poe": "one", "gpoe": "avg", "bcm": "one", "rbcm": "entropy"}
_BCM_CORRECTION = {"poe": False, "gpoe": False, "bcm": True, "rbcm": True}


def expert_specs(fitted, axis_name: str):
    """The layout of every leaf of a FittedExperts / SparseExperts on the
    mesh, as a same-typed tuple: `(axis_name,)` splits the leaf's agent
    axis (its first) over the members, `()` replicates it. log_theta is
    replicated; the NPAE cross-Gram cache has no sharded layout, so
    Kcross must be None (sparse fleets never carry one)."""
    a = (axis_name,)
    if isinstance(fitted, SparseExperts):
        return SparseExperts(log_theta=(), Z=a, Lmm=a, LS=a, c=a, tr_corr=a)
    if fitted.Kcross is not None:
        raise ValueError(
            "expert_specs: Kcross (the NPAE cross-Gram cache) has no "
            "agent-sharded layout; refit with cache_cross=False")
    return FittedExperts(log_theta=(), Xp=a, yp=a, L=a, alpha=a, Kcross=None)


def replicated_specs(fitted):
    """All-replicated layout (the 1-agent grBCM communication expert)."""
    return type(fitted)(*(None if t is None else () for t in fitted))


def shard_experts(fitted, mesh, axis_name: str = "agents",
                  *, replicate: bool = False) -> list:
    """Place a fitted fleet on `mesh`: one experts tuple per member, on its
    device, holding that member's contiguous block of agents (or the whole
    fleet, `replicate=True`, for the communication expert)."""
    specs = replicated_specs(fitted) if replicate \
        else expert_specs(fitted, axis_name)
    n = int(mesh.shape[axis_name])
    Mb = fitted.num_agents // n
    out = []
    for i, dev in enumerate(mesh.devices):
        leaves = []
        for t, spec in zip(fitted, specs):
            if t is None:
                leaves.append(None)
            elif spec:
                leaves.append(t[i * Mb:(i + 1) * Mb].to(dev))
            else:
                leaves.append(t.to(dev))
        out.append(type(fitted)(*leaves))
    return out


def _strip_kcross(fitted):
    """Drop the (un-shardable) NPAE cross-Gram cache from a dense fleet;
    sparse fleets carry no such cache and pass through untouched."""
    if isinstance(fitted, FittedExperts) and fitted.Kcross is not None:
        return fitted._replace(Kcross=None)
    return fitted


def _spec(t):
    return None if t is None else (tuple(t.shape), t.dtype)


class ShardedEngine:
    """Serving front-end with the fleet sharded over the agent axis.

    Mirrors `PredictionEngine.predict` for the DAC family: poe gpoe bcm
    rbcm grbcm, the CBNN variants nn_poe nn_gpoe nn_bcm nn_rbcm nn_grbcm,
    and npae_sparse from sparse experts; `predict_routed` for CBNN query
    routing. The member count must divide the agent count; member i owns
    agents [i M/ndev, (i+1) M/ndev), a contiguous block of the stripe
    layout `gp.stripe_partition` produces, so blocks are spatially
    coherent and routing is meaningful.

    The consensus graph is the RING of members, not a user-supplied
    adjacency: its DAC fixed point is the same network average, so
    converged outputs match the replicated engine on any connected graph.
    `consensus="exact"` replaces the DAC iteration with the finite
    ring_allsum protocol.

    `jit_cache_misses` counts the distinct (mode, method, query geometry)
    programs served, as the reference's trace count does; `swap_experts`
    replaces the factors (same shapes) without a new geometry.
    """

    METHODS = ("poe", "gpoe", "bcm", "rbcm", "grbcm", "nn_poe", "nn_gpoe",
               "nn_bcm", "nn_rbcm", "nn_grbcm", "npae_sparse")

    def __init__(self, fitted, mesh, *, axis_name: str = "agents",
                 chunk: int = 256, dac_iters: int = 200, eta_nn: float = 0.1,
                 consensus: str = "dac", npae_jitter: float = 1e-6,
                 fitted_aug=None, fitted_comm=None,
                 stream_mean: bool = False):
        if axis_name not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {axis_name!r}")
        if consensus not in ("dac", "exact"):
            raise ValueError(f"consensus must be 'dac' or 'exact', "
                             f"got {consensus!r}")
        self.mesh = mesh
        self.axis_name = axis_name
        self.devices = tuple(mesh.devices)
        self.ndev = int(mesh.shape[axis_name])
        M = fitted.num_agents
        if M % self.ndev:
            raise ValueError(f"{M} agents do not shard over {self.ndev} "
                             f"devices (need ndev | M)")
        self.chunk = int(chunk)
        self.dac_iters = int(dac_iters)
        self.eta_nn = float(eta_nn)
        self.consensus = consensus
        self.npae_jitter = float(npae_jitter)
        self.stream_mean = bool(stream_mean)
        self.diagnostics = False
        self._lock = threading.Lock()
        self._served: set = set()
        self._trace_count = 0
        self._traces_total = default_registry().counter(
            "gp_jit_traces_total", "engine traces (compiled programs), by "
            "engine and method")
        self.fitted_aug = self.fitted_comm = None
        self._specs = {}
        self._place(fitted, fitted_aug, fitted_comm)

    def _place(self, fitted, fitted_aug=None, fitted_comm=None):
        """Shard the given expert sets onto the mesh (a set not given
        stays as it is). The NPAE cross-Gram cache has no sharded
        consumer: it is dropped rather than forcing callers to refit."""
        fitted = _strip_kcross(fitted)
        self._specs["fitted"] = [_spec(t) for t in fitted]
        self.fitted = shard_experts(fitted, self.mesh, self.axis_name)
        if fitted_aug is not None:
            fitted_aug = _strip_kcross(fitted_aug)
            self._specs["fitted_aug"] = [_spec(t) for t in fitted_aug]
            self.fitted_aug = shard_experts(fitted_aug, self.mesh,
                                            self.axis_name)
        if fitted_comm is not None:
            self._specs["fitted_comm"] = [_spec(t) for t in fitted_comm]
            self.fitted_comm = shard_experts(fitted_comm, self.mesh,
                                             self.axis_name, replicate=True)
        # per-agent centroids drive host-side query routing (nearest agent
        # -> owning member); tiny, so they live on the host
        self._centroids = fitted.Xp.mean(1).detach().cpu().numpy()
        self._dtype = fitted.Xp.dtype

    @property
    def num_agents(self) -> int:
        return sum(f.num_agents for f in self.fitted)

    # -- member-local tile computation ---------------------------------------

    def _moments(self, f, Xq, *, stream_mean: bool = False):
        """Per-agent posterior moments for one member's block, dense or
        sparse experts."""
        if isinstance(f, SparseExperts):
            return sparse_moments_cached(f.log_theta, f.Z, f.Lmm, f.LS, f.c,
                                         Xq, stream_mean=stream_mean)
        return local_moments_cached(f.log_theta, f.Xp, f.L, f.alpha, Xq,
                                    stream_mean=stream_mean)

    def _scores(self, f, Xq):
        if isinstance(f, SparseExperts):
            return sparse_scores(f.log_theta, f.Z, f.Lmm, f.LS, Xq)
        return cbnn_scores_cached(f.log_theta, f.Xp, f.L, Xq)

    def _masks(self, Xqs, *, ring: bool):
        """CBNN masks (Mb, chunk), one per member. ring=True closes the
        >= 1-agent guarantee globally (exact ring max of the members' best
        scores: full-fleet mode); ring=False keeps it within each block
        (routed mode)."""
        scores = [self._scores(f, Xq) for f, Xq in zip(self.fitted, Xqs)]
        if not ring:
            return [_mask_from_scores(s, self.eta_nn) for s in scores]
        gmax = ring_allmax([s.amax(0) for s in scores])
        return [(s >= self.eta_nn) | (s >= g[None])
                for s, g in zip(scores, gmax)]

    def _payloads(self, method: str, Xqs, masks, *, ring: bool):
        """Per-member consensus payloads: the (Mb, chunk, 3) summands of
        `_poe_summands`, by the replicated cores' own `_poe_beta` /
        `_grbcm_beta`, and the communication expert's moments (grbcm).

        ring=True is full-fleet mode (gpoe's M_eff is the network-wide
        participant count, closed with an exact ring sum); ring=False is
        routed mode, where every member serves different queries and the
        count is the block's own."""
        base = method[3:] if method.startswith("nn_") else method
        Mb = self.fitted[0].num_agents
        out, comm = [], []
        for i, Xq in enumerate(Xqs):
            mask = None if masks is None else masks[i]
            if base == "grbcm":
                mu, var = self._moments(self.fitted_aug[i], Xq,
                                        stream_mean=self.stream_mean)
                # the communication expert's mean takes the replicated
                # engine's path (the reference's sharded engine solves for
                # it whatever stream_mean says; in float32 the two paths
                # part by the kernel's rounding)
                mu_c, var_c = self._moments(self.fitted_comm[i], Xq,
                                            stream_mean=self.stream_mean)
                m = torch.ones_like(mu) if mask is None else mask.to(mu.dtype)
                gidx = i * Mb + torch.arange(Mb, device=mu.device)
                beta = _grbcm_beta(var, var_c[0], m, gidx)
                out.append(_poe_summands(beta, mu, var))
                comm.append((mu_c[0], var_c[0]))
                continue
            mu, var = self._moments(self.fitted[i], Xq,
                                    stream_mean=self.stream_mean)
            m = torch.ones_like(mu) if mask is None else mask.to(mu.dtype)
            out.append((mu, var, m))
        if base == "grbcm":
            return out, comm
        if base == "gpoe":
            # eq. 12 'avg' weights need the participant count; mask counts
            # are small integers, so the exact ring sum reproduces the
            # replicated M_eff bit for bit
            counts = [m.sum(0) for _, _, m in out]
            if ring:
                counts = ring_allsum(counts)
        else:
            counts = [None] * len(out)
        pv = self.fitted[0].prior_var
        return [_poe_summands(_poe_beta(var, pv.to(var.device), m, c,
                                        _BETA_MODE[base]), mu, var)
                for (mu, var, m), c in zip(out, counts)], None

    def _posterior(self, method, sums, comm):
        base = method[3:] if method.startswith("nn_") else method
        if base == "grbcm":
            mu_c, var_c = comm
            return _grbcm_posterior(sums[..., 0], sums[..., 1], sums[..., 2],
                                    mu_c, var_c)
        pv = self.fitted[0].prior_var.to(sums.device)
        return _poe_posterior(sums[..., 0], sums[..., 1], sums[..., 2], pv,
                              _BCM_CORRECTION[base])

    def _full_tile(self, method, Xq):
        """One query tile, full-fleet mode: member-local payloads + ring
        consensus, read out on member 0."""
        nn = method.startswith("nn_")
        Xqs = [Xq.to(d) for d in self.devices]
        masks = self._masks(Xqs, ring=True) if nn else None
        w0, comm = self._payloads(method, Xqs, masks, ring=True)
        parts = [w.sum(0) for w in w0]                  # (chunk, 3) each
        res_traj = None
        if self.consensus == "exact":
            sums = ring_allsum(parts)
            res = Xq.new_zeros(())
            if self.diagnostics:
                res_traj = Xq.new_zeros(self.dac_iters)
        elif self.diagnostics:
            # the per-round maximin spread trajectory, at the cost of two
            # more collectives a round
            w, res_traj = dac_sharded(parts, self.dac_iters,
                                      with_residuals=True)
            res = res_traj[-1]
            sums = [self.ndev * x for x in w]
        else:
            w = dac_sharded(parts, self.dac_iters)      # ~ total / ndev
            res = dac_sharded_residual(w)[0]
            sums = [self.ndev * x for x in w]
        # the members fold ring messages in different orders: their mean
        # on member 0 is the replicated result (the reference's pmean)
        d0 = self.devices[0]
        total = sum(s.to(d0) for s in sums) / self.ndev
        mean, v = self._posterior(method, total,
                                  None if comm is None else comm[0])
        perq = {"mean": mean, "var": v}
        if nn:
            perq["mask_t"] = torch.cat([m.to(d0) for m in masks]).T
        red = {"dac_residual": res.to(d0)}
        if res_traj is not None:
            red["dac_residuals"] = res_traj.to(d0)
        return perq, red

    def _sparse_npae_tile(self, Xq):
        """One query tile of the sharded low-rank NPAE path: each member
        computes its block's Nystrom factors (mu, kA, U), `ring_allgather`
        exchanges them and the inducing sets exactly, and the full (q, M, M)
        cross-covariance and NPAE solve are the replicated engine's code on
        member 0's copies — sharded == replicated by construction. No
        averaging consensus, hence a zero dac_residual."""
        facs = [sparse_npae_factors(f.log_theta, f.Z, f.Lmm, f.LS, f.c,
                                    Xq.to(f.Z.device)) for f in self.fitted]
        M = self.num_agents
        f0 = self.fitted[0]
        Z = ring_allgather([f.Z for f in self.fitted])[0]
        mu, kA, U = (ring_allgather([fa[k] for fa in facs])[0]
                     for k in range(3))
        Z = Z.reshape((M,) + tuple(f0.Z.shape[1:]))
        mu, kA = mu.reshape(M, -1), kA.reshape(M, -1)
        U = U.reshape((M,) + tuple(U.shape[2:]))
        CA = cross_lowrank(f0.log_theta, Z, U, kA)
        mean, v = npae(mu, kA, CA, f0.prior_var, jitter=self.npae_jitter)
        return ({"mean": mean, "var": v},
                {"dac_residual": Xq.new_zeros((), device=mean.device)})

    def _routed_tiles(self, method, Xqs):
        """One query tile per member, routed mode: each member's block only
        — local mask (>= 1 guarantee within the block), local masked
        aggregation, no messages between members."""
        masks = self._masks(Xqs, ring=False)
        w0, comm = self._payloads(method, Xqs, masks, ring=False)
        out = []
        for i, (w, mask) in enumerate(zip(w0, masks)):
            mean, v = self._posterior(method, w.sum(0),
                                      None if comm is None else comm[i])
            out.append({"mean": mean, "var": v,
                        "n_selected": mask.sum(0)})
        return out

    # -- serving entry points ------------------------------------------------

    def _count(self, key, method):
        with self._lock:
            if key not in self._served:
                self._served.add(key)
                self._trace_count += 1
                self._traces_total.inc(engine="sharded", method=method)

    def _check(self, method: str):
        if "grbcm" in method and (self.fitted_aug is None
                                  or self.fitted_comm is None):
            raise ValueError("grbcm methods need fitted_aug and fitted_comm")

    def predict(self, method: str, Xs):
        """Full-fleet sharded serving -> (mean (Nt,), var (Nt,), info) on
        member 0's device. info carries the worst-tile ring-DAC residual
        and, for nn_* methods, the (M, Nt) CBNN mask."""
        if method not in self.METHODS:
            raise ValueError(
                f"unknown sharded method {method!r}; one of {self.METHODS} "
                f"(the dense NPAE family needs strongly-complete exchange "
                f"of O(Ni) factors and is served by the replicated "
                f"PredictionEngine; its low-rank counterpart 'npae_sparse' "
                f"DOES shard — fit with FleetConfig(sparse_m=...))")
        if method == "npae_sparse" and \
                not isinstance(self.fitted[0], SparseExperts):
            raise ValueError(
                "npae_sparse serves from SparseExperts only — fit with "
                "FleetConfig(sparse_m=...) / fit_sparse_experts")
        self._check(method)
        Xs = torch.as_tensor(Xs, dtype=self._dtype, device=self.devices[0])
        self._count(("full", method, tuple(Xs.shape), Xs.dtype,
                     self.diagnostics), method)
        if method == "npae_sparse":
            tile = self._sparse_npae_tile
        else:
            def tile(Xq):
                return self._full_tile(method, Xq)
        perq, red = map_query_tiles(tile, Xs, self.chunk)
        info = dict(red)
        mask_t = perq.pop("mask_t", None)
        if mask_t is not None:
            info["mask"] = mask_t.T
        return perq["mean"], perq["var"], info

    def _route(self, Xs: np.ndarray) -> np.ndarray:
        """Host-side CBNN routing proxy: nearest agent centroid -> owning
        member. For stationary kernels the eq. 39 score decays with
        distance to the agent's data, so the centroid-nearest agent is the
        max-score agent away from stripe boundaries; the exact
        thresholding then happens on the routed member."""
        d2 = ((Xs[:, None, :] - self._centroids[None, :, :]) ** 2).sum(-1)
        Mb = self._centroids.shape[0] // self.ndev
        return d2.argmin(axis=1) // Mb

    def predict_routed(self, method: str, Xs):
        """CBNN-routed serving (nn_* methods) -> (mean, var, info) on member
        0's device. Each query runs on ONE member (nearest-centroid
        routing), against that member's agent block only. info["shard"],
        info["n_selected"] and info["batch_per_shard"] let callers audit
        the approximation."""
        if not method.startswith("nn_"):
            raise ValueError("predict_routed serves the CBNN nn_* methods; "
                             f"got {method!r}")
        if method not in self.METHODS:
            raise ValueError(f"unknown sharded method {method!r}")
        self._check(method)
        Xh = (Xs.detach().cpu().numpy() if isinstance(Xs, torch.Tensor)
              else np.asarray(Xs))
        Nt, D = Xh.shape
        shard = self._route(Xh)
        counts = np.bincount(shard, minlength=self.ndev)
        # batch-per-member is quantized to chunk * 2^k: the geometry depends
        # on routing skew only through log-many sizes
        n_chunks = -(-max(int(counts.max()), 1) // self.chunk)
        B = self.chunk * (1 << (n_chunks - 1).bit_length())
        Xr = np.empty((self.ndev, B, D), dtype=Xh.dtype)
        slot = np.empty(Nt, dtype=np.int64)
        Mb = self._centroids.shape[0] // self.ndev
        for g in range(self.ndev):
            qs = np.flatnonzero(shard == g)
            Xr[g, :qs.size] = Xh[qs]
            # pad with a point the block owns so padded rows stay in-region
            filler = Xh[qs[-1]] if qs.size else self._centroids[g * Mb]
            Xr[g, qs.size:] = filler
            slot[qs] = g * B + np.arange(qs.size)
        self._count(("routed", method, B, D, self._dtype), method)
        d0 = self.devices[0]
        Xrs = [torch.as_tensor(Xr[g], dtype=self._dtype, device=d)
               for g, d in enumerate(self.devices)]
        outs = [[] for _ in range(self.ndev)]
        for t in range(B // self.chunk):
            tiles = self._routed_tiles(
                method, [x[t * self.chunk:(t + 1) * self.chunk]
                         for x in Xrs])
            for g, o in enumerate(tiles):
                outs[g].append(o)
        perq = {k: torch.cat([torch.cat([o[k] for o in outs[g]]).to(d0)
                              for g in range(self.ndev)])
                for k in ("mean", "var", "n_selected")}
        idx = torch.as_tensor(slot, device=d0)
        info = {"shard": shard, "batch_per_shard": B,
                "n_selected": perq["n_selected"][idx]}
        return perq["mean"][idx], perq["var"][idx], info

    @property
    def jit_cache_misses(self) -> int:
        """Distinct (mode, method, query geometry) programs served so far,
        the reference's trace count. Flat across requests => every
        dispatch reused a served geometry."""
        return self._trace_count

    def set_diagnostics(self, flag: bool):
        """Toggle consensus-diagnostics capture: when on, full-fleet
        `predict` info also carries the per-round ring-DAC maximin spread
        trajectory ("dac_residuals", worst tile per round). As in the
        reference, a toggle starts the served-geometry count afresh."""
        flag = bool(flag)
        if flag != self.diagnostics:
            self.diagnostics = flag
            with self._lock:
                self._served.clear()

    def warm_slots(self, method: str, slots, *, input_dim: int | None = None,
                   dtype=None):
        """Serve one zero batch of every query-batch geometry in `slots`
        (serving schedulers call this at tenant registration)."""
        D = self.fitted[0].Xp.shape[-1] if input_dim is None \
            else int(input_dim)
        dt = self._dtype if dtype is None else dtype
        for s in slots:
            self.predict(method, torch.zeros((int(s), D), dtype=dt,
                                             device=self.devices[0]))

    def swap_experts(self, fitted, fitted_aug=None, fitted_comm=None):
        """Replace the served factors (same shapes and dtypes) without a
        new geometry; a refit carrying the NPAE cross-Gram cache is
        accepted (the cache is stripped before the comparison)."""
        fitted = _strip_kcross(fitted)
        if fitted_aug is not None:
            fitted_aug = _strip_kcross(fitted_aug)
        for name, new in (("fitted", fitted), ("fitted_aug", fitted_aug),
                          ("fitted_comm", fitted_comm)):
            old = self._specs.get(name)
            if new is not None and old is not None \
                    and [_spec(t) for t in new] != old:
                raise ValueError(f"swap_experts: {name} shapes changed — "
                                 f"rebuild the ShardedEngine")
        self._place(fitted, fitted_aug, fitted_comm)
