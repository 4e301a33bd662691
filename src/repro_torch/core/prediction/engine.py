"""Factor-cached, query-tiled prediction engine — the serving hot path.

Counterpart of `repro.core.prediction.engine` (replicated mode):

  FittedExperts    — per-agent Cholesky L_i and weights alpha_i =
                     C_i^{-1} y_i, computed once after training
                     (`fit_experts`, optionally with the NPAE cross-Gram
                     cache), or carried over from the JAX package's fit
                     (`FittedExperts.from_numpy`).
  map_query_tiles  — a loop over fixed-size query tiles: peak memory is
                     O(chunk * M * Ni) at any Nt.
  PredictionEngine — serving front-end: all 13 decentralized methods, the
                     centralized references cen_*, and npae_sparse, from
                     FittedExperts or from sparse pseudo-representation
                     experts (core.sparse.SparseExperts, isinstance
                     dispatch; the dense NPAE family needs FittedExperts).
                     With `stream_mean=True` the posterior means ride the
                     fused Gram-matvec kernel (kernels.rbf_matvec), one
                     launch per query tile and expert set. `swap_experts`
                     replaces the served factors of a streaming fleet
                     (core.online, dense only) in place; `rewire` applies
                     a membership change (new adjacency, new M).
                     `predict(..., fault_plan=)` serves a chaos plan's
                     consensus faults over the surviving subgraph
                     (consensus.degraded), flagged degraded or raising
                     ConsensusDiverged; `warm_slots` serves one batch of
                     every slot geometry a serving scheduler will send.

PyTorch runs eagerly, so nothing is compiled per request; the reference's
trace counter (`gp_jit_traces_total` in the default `obs` registry, and
`jit_cache_misses`) counts here what the reference's traces count: the
distinct (method, query geometry) pairs served. `set_diagnostics(True)`
adds the per-round DAC (and JOR) residual trajectories to `predict`'s
info without changing a prediction. A degraded dispatch is a geometry of
its own, as the reference's degraded program is a trace of its own, and
every plan of one structure shares it.

The engine may be called from several threads at once (a serving
scheduler's worker, and after a watchdog stall a second worker while the
wedged call still runs): its caches (the served geometries, the per-plan
fault arrays) are mutated only under the engine's lock.
"""
from __future__ import annotations

import threading
from functools import partial
from typing import Mapping, NamedTuple

import numpy as np
import torch

from ...device import resolve_device
from ...obs import default_registry
from ...obs.tracing import span
from ..consensus.degraded import (ConsensusDiverged, masked_perrons,
                                  perron_sums)
from ..consensus.graph import connected_components
from ..gp.kernel import unpack
from . import aggregation as agg
from .cbnn import _mask_from_scores, cbnn_mask_cached
from .decentralized import (dec_bcm_from_moments, dec_gpoe_from_moments,
                            dec_grbcm_from_moments, dec_nn_npae_from_terms,
                            dec_npae_from_terms, dec_npae_star_from_terms,
                            dec_poe_from_moments, dec_rbcm_from_moments)
from .local import (chol_factors, cross_gram, local_moments_cached,
                    npae_terms_cached, stream_means)
from ..sparse import (SparseExperts, npae_terms_lowrank,
                      sparse_moments_cached, sparse_scores)


class FittedExperts(NamedTuple):
    """Per-agent state computed once after training."""
    log_theta: torch.Tensor   # (D+2,)
    Xp: torch.Tensor          # (M, Ni, D)
    yp: torch.Tensor          # (M, Ni)
    L: torch.Tensor           # (M, Ni, Ni)  chol(K(X_i, X_i) + sigma_eps^2 I)
    alpha: torch.Tensor       # (M, Ni)      C_i^{-1} y_i
    Kcross: torch.Tensor | None = None   # (M, M, Ni, Ni) cross-agent Gram
    #                                      blocks (fit_experts cache_cross)

    @property
    def num_agents(self) -> int:
        return self.Xp.shape[0]

    @property
    def prior_var(self) -> torch.Tensor:
        _, sigma_f, _ = unpack(self.log_theta)
        return sigma_f**2

    def to(self, device) -> "FittedExperts":
        return FittedExperts(*(None if t is None else t.to(device)
                               for t in self))

    @classmethod
    def from_numpy(cls, arrays: Mapping, device=None) -> "FittedExperts":
        """Carry a fitted fleet across from numpy arrays keyed by field name
        (log_theta, Xp, yp, L, alpha and optionally Kcross) — e.g. the JAX
        package's FittedExperts via `np.asarray` — onto `device` (default:
        cuda). A missing Kcross, or the reference's None, leaves it None."""
        dev = resolve_device(device)

        def field(name):
            a = arrays.get(name)
            if a is None or np.asarray(a).dtype == object:
                return None
            return torch.tensor(np.asarray(a), device=dev)
        return cls(*(field(name) for name in cls._fields))


def fit_experts(log_theta, Xp, yp, jitter: float = 1e-8,
                cache_cross: bool = False,
                cross_cache_limit_mb: float = 1024.0) -> FittedExperts:
    """Factorize every agent's kernel matrix once; reused by all methods.

    `cache_cross=True` also precomputes the (M, M, Ni, Ni) cross-agent Gram
    blocks that the NPAE family otherwise assembles for every query tile,
    trading O(M^2 Ni^2) memory for the dominant per-request cost. The size
    is checked against `cross_cache_limit_mb` before anything is built
    (the reference checks it after factorizing); raise the limit
    explicitly for big fleets."""
    if cache_cross:
        M, Ni = Xp.shape[0], Xp.shape[1]
        est_bytes = M * M * Ni * Ni * Xp.element_size()
        if est_bytes / 2**20 > cross_cache_limit_mb:
            raise ValueError(
                f"cache_cross would materialize {est_bytes:,} bytes "
                f"({est_bytes / 2**20:.2f} MB) of cross-agent Gram blocks "
                f"(M={M}, Ni={Ni}) > limit {cross_cache_limit_mb:.0f} MB; "
                f"raise cross_cache_limit_mb, serve without the cache, or "
                f"serve the NPAE family from sparse pseudo-representations "
                f"instead — FleetConfig(sparse_m=...) with method "
                f"'npae_sparse' needs no cross-Gram at all "
                f"(docs/sparse_experts.md)")
    L, alpha = chol_factors(log_theta, Xp, yp, jitter)
    Kcross = cross_gram(log_theta, Xp) if cache_cross else None
    return FittedExperts(log_theta, Xp, yp, L, alpha, Kcross)


def map_query_tiles(tile_fn, Xs, chunk: int):
    """Apply `tile_fn((chunk, D)) -> (per_query dict, reduced dict)` over
    fixed-size query tiles in order.

    Per-query leaves have leading axis `chunk`; they are stitched along the
    query axis and the padding tail is stripped. Reduced leaves are
    combined with an elementwise max over tiles (the worst tile).
    """
    Nt = Xs.shape[0]
    n_tiles = -(-Nt // chunk)
    pad = n_tiles * chunk - Nt
    # edge-replicate the tail: padded slots duplicate the LAST REAL query,
    # so the max-reduced residuals describe the served workload
    padded = torch.cat([Xs, Xs[-1:].expand(pad, -1)]) if pad else Xs
    outs = []
    for t in range(n_tiles):
        with span("engine.tile"):
            outs.append(tile_fn(padded[t * chunk:(t + 1) * chunk]))
    perq = {k: torch.cat([o[0][k] for o in outs])[:Nt] for k in outs[0][0]}
    reduced = {k: torch.stack([o[1][k] for o in outs]).amax(0)
               for k in outs[0][1]}
    return perq, reduced


_DAC_CORES = {"poe": dec_poe_from_moments, "gpoe": dec_gpoe_from_moments,
              "bcm": dec_bcm_from_moments, "rbcm": dec_rbcm_from_moments}


class PredictionEngine:
    """Serving front-end over FittedExperts or SparseExperts: query-tiled
    decentralized methods and their centralized references.

    Decentralized: poe gpoe bcm rbcm grbcm npae npae_star and the CBNN
    variants nn_poe nn_gpoe nn_bcm nn_rbcm nn_grbcm nn_npae (paper Alg.
    5-18); npae_sparse from sparse factors only.
    Centralized references: cen_poe cen_gpoe cen_bcm cen_rbcm cen_grbcm
    cen_npae.

    The grbcm variants also need `fitted_aug` (the augmented experts) and
    `fitted_comm` (the communication expert as a 1-agent FittedExperts),
    paper eq. 16-17; CBNN scores always come from the BASE local datasets
    (eq. 39 is defined on D_i). The dense NPAE family (npae npae_star
    nn_npae cen_npae) needs FittedExperts.

    The experts and the adjacency move to `device` (default: cuda) at
    construction; queries are moved there per call.
    """

    METHODS = ("poe", "gpoe", "bcm", "rbcm", "grbcm", "npae", "npae_star",
               "nn_poe", "nn_gpoe", "nn_bcm", "nn_rbcm", "nn_grbcm",
               "nn_npae", "npae_sparse", "cen_poe", "cen_gpoe", "cen_bcm",
               "cen_rbcm", "cen_grbcm", "cen_npae")

    # exact-NPAE members that need the dense cross-Gram and therefore can
    # never serve from SparseExperts (npae_sparse is their low-rank stand-in)
    _DENSE_ONLY = ("npae", "npae_star", "nn_npae", "cen_npae")

    def __init__(self, fitted: FittedExperts | SparseExperts, A, *,
                 chunk: int = 256, dac_iters: int = 200,
                 jor_iters: int = 500, dale_iters: int = 2000,
                 pm_iters: int = 100, eta_nn: float = 0.1,
                 npae_jitter: float = 1e-6,
                 fitted_aug: FittedExperts | SparseExperts | None = None,
                 fitted_comm: FittedExperts | SparseExperts | None = None,
                 stream_mean: bool = False, degraded_tol: float = 1e-2,
                 device=None):
        self.device = resolve_device(device)
        self.fitted = fitted.to(self.device)
        self.fitted_aug = None if fitted_aug is None \
            else fitted_aug.to(self.device)
        self.fitted_comm = None if fitted_comm is None \
            else fitted_comm.to(self.device)
        self.A = torch.as_tensor(A).to(self.device, torch.float64)
        if self.A.shape[0] != self.fitted.num_agents:
            raise ValueError(f"adjacency for {self.A.shape[0]} agents vs "
                             f"{self.fitted.num_agents} fitted agents")
        self.chunk = int(chunk)
        self.dac_iters = int(dac_iters)
        self.jor_iters = int(jor_iters)
        self.dale_iters = int(dale_iters)
        self.pm_iters = int(pm_iters)
        self.eta_nn = float(eta_nn)
        self.npae_jitter = float(npae_jitter)
        self.stream_mean = bool(stream_mean)
        self.degraded_tol = float(degraded_tol)
        self.diagnostics = False
        # guards _served, _trace_count and _chaos_cache (see the module
        # docstring): held only while a cache is read and mutated
        self._lock = threading.Lock()
        self._served: set = set()     # (method, shape, dtype, mode) keys
        self._trace_count = 0
        self._chaos_cache: dict = {}  # FaultPlan -> (device arrays, census)
        reg = default_registry()
        self._traces_total = reg.counter(
            "gp_jit_traces_total", "engine traces (compiled programs), by "
            "engine and method")
        self._degraded_total = reg.counter(
            "gp_degraded_predictions_total", "predictions served in degraded "
            "mode (dropped agents / partitions / scrubbed payloads)")
        self._diverged_total = reg.counter(
            "gp_consensus_diverged_total", "predictions that raised "
            "ConsensusDiverged (residual or finiteness guard)")
        self._scrubbed_gauge = reg.gauge(
            "gp_scrubbed_payloads", "agents with non-finite consensus "
            "payloads scrubbed in the last degraded prediction")
        self._alive_gauge = reg.gauge(
            "gp_alive_agents", "agents alive at the last degraded "
            "prediction's readout")

    def _queries(self, Xs):
        """Queries as a tensor on the engine's device in the experts'
        dtype."""
        return torch.as_tensor(Xs, dtype=self.fitted.Xp.dtype,
                               device=self.device)

    # -- per-tile computation ------------------------------------------------

    def _moments(self, f, Xq):
        """Local expert moments (M, Nt) from dense or sparse factors: the
        isinstance dispatch that lets every PoE/BCM/CBNN aggregation serve
        both fleets."""
        with span("engine.moments"):
            if isinstance(f, SparseExperts):
                return sparse_moments_cached(
                    f.log_theta, f.Z, f.Lmm, f.LS, f.c, Xq,
                    stream_mean=self.stream_mean)
            return local_moments_cached(f.log_theta, f.Xp, f.L, f.alpha, Xq,
                                        stream_mean=self.stream_mean)

    def _mask(self, f, Xq):
        """CBNN participation mask (eq. 39) from dense or sparse factors:
        both score forms equal sigma_f^2 - var_i, so eta_nn thresholds are
        comparable across expert representations."""
        with span("engine.moments"):
            if isinstance(f, SparseExperts):
                return _mask_from_scores(
                    sparse_scores(f.log_theta, f.Z, f.Lmm, f.LS, Xq),
                    self.eta_nn)
            return cbnn_mask_cached(f.log_theta, f.Xp, f.L, Xq,
                                    self.eta_nn)[0]

    def _terms(self, f: FittedExperts, Xq):
        with span("engine.moments"):
            return npae_terms_cached(f.log_theta, f.Xp, f.L, f.alpha, Xq,
                                     Kcross=f.Kcross)

    def _tile(self, method: str, Xq, chaos=None):
        f, fa, fc = self.fitted, self.fitted_aug, self.fitted_comm
        A, pv = self.A, f.prior_var
        nn = method.startswith("nn_")
        base = method[3:] if nn else method
        red = {}
        dac_fn = None

        def degrade(mu, var, m):
            """Chaos payload stage: inject the plan's NaN corruption, then
            SCRUB: non-finite per-agent payloads are zeroed, excluded from
            the participation mask and counted, so corruption never reaches
            the aggregation arithmetic silently."""
            mu = torch.where(chaos["corrupt"][:, None], torch.nan, mu)
            ok = torch.isfinite(mu) & torch.isfinite(var)
            eligible = chaos["payload"][:, None] > 0
            red["scrubbed"] = (~ok & eligible).any(1).sum().to(mu.dtype)
            m2 = chaos["payload"][:, None] * ok.to(mu.dtype)
            if m is not None:
                m2 = m2 * torch.broadcast_to(m, mu.shape).to(mu.dtype)
            return (torch.where(ok, mu, torch.zeros_like(mu)),
                    torch.where(ok, var, pv.expand_as(var)), m2)

        if chaos is not None:
            def dac_fn(w0, A_, iters):
                with span("consensus.dac"):
                    return perron_sums(w0, chaos["perrons"],
                                       chaos["alive_seq"], chaos["readout"],
                                       chaos["n_relay"])

        if method == "nn_npae":
            # the CBNN scores (eq. 39) are the NPAE terms' k_A
            mu, kA, CA = self._terms(f, Xq)
            mask = _mask_from_scores(kA, self.eta_nn)
            A_dale, readout = A, None
            if chaos is not None:
                mu, _, mask = degrade(mu, torch.zeros_like(mu) + pv, mask)
                A_dale, readout = chaos["A_live"], chaos["readout"]
            mean, v, info = dec_nn_npae_from_terms(
                mask, mu, kA, CA, pv, A_dale, dale_iters=self.dale_iters,
                jitter=self.npae_jitter, readout=readout)
            red["dale_residual"] = info["dale_residual"]
            return {"mean": mean, "var": v, "mask_t": mask.T}, red
        mask = self._mask(f, Xq) if nn else None
        if base in _DAC_CORES:
            mu, var = self._moments(f, Xq)
            if chaos is not None:
                mu, var, mask = degrade(mu, var, mask)
            mean, v, info = _DAC_CORES[base](mu, var, pv, A,
                                             iters=self.dac_iters, mask=mask,
                                             dac_fn=dac_fn)
            red["dac_residual"] = info["dac_residuals"][-1]
            if self.diagnostics:
                # the full per-round trajectory, max-reduced elementwise
                # over tiles (the worst tile per round): (dac_iters,)
                red["dac_residuals"] = info["dac_residuals"]
        elif base in ("grbcm", "cen_grbcm"):
            mu_a, var_a = self._moments(fa, Xq)
            mu_c, var_c = self._moments(fc, Xq)
            if base == "cen_grbcm":
                mean, v = agg.grbcm(mu_a, var_a, mu_c[0], var_c[0])
            else:
                if chaos is not None:
                    # the communication expert is a serving-host dataset,
                    # not a fleet member: only the augmented experts fail
                    mu_a, var_a, mask = degrade(mu_a, var_a, mask)
                mean, v, info = dec_grbcm_from_moments(
                    mu_a, var_a, mu_c[0], var_c[0], A, iters=self.dac_iters,
                    mask=mask, dac_fn=dac_fn)
                red["dac_residual"] = info["dac_residuals"][-1]
                if self.diagnostics:
                    red["dac_residuals"] = info["dac_residuals"]
        elif method in ("npae", "npae_star"):
            mu, kA, CA = self._terms(f, Xq)
            if chaos is not None:
                mu, _, mask = degrade(mu, torch.zeros_like(mu) + pv, mask)
            core = (dec_npae_from_terms if method == "npae"
                    else partial(dec_npae_star_from_terms,
                                 pm_iters=self.pm_iters))
            mean, v, info = core(mu, kA, CA, pv, A, jor_iters=self.jor_iters,
                                 dac_iters=self.dac_iters,
                                 jitter=self.npae_jitter,
                                 with_residuals=self.diagnostics,
                                 mask=mask, dac_fn=dac_fn)
            red["dac_residual"] = info["dac_residuals"][-1]
            red["jor_residual"] = info["jor_residual"]
            if self.diagnostics:
                red["dac_residuals"] = info["dac_residuals"]
                red["jor_residuals"] = info["jor_residuals"]
        elif method == "npae_sparse":
            # low-rank NPAE: the cross-covariance through the pseudo-points,
            # solved by the same aggregation core as the exact family
            mu, kA, CA = npae_terms_lowrank(f.log_theta, f.Z, f.Lmm, f.LS,
                                            f.c, Xq)
            mean, v = agg.npae(mu, kA, CA, pv, jitter=self.npae_jitter)
        elif method == "cen_npae":
            mu, kA, CA = self._terms(f, Xq)
            mean, v = agg.npae(mu, kA, CA, pv)
        else:
            mu, var = self._moments(f, Xq)
            fn = getattr(agg, method[4:])
            mean, v = fn(mu, var, pv) if method in ("cen_bcm", "cen_rbcm") \
                else fn(mu, var)
        perq = {"mean": mean, "var": v}
        if mask is not None:
            perq["mask_t"] = mask.T                       # query axis leads
        return perq, red

    def _chaos_arrays(self, plan):
        """The fault arrays and the degradation census of a consensus-
        faulty FaultPlan: built on the host and moved to the device once,
        cached per plan (under the engine's lock).

        readout = the largest connected component of live agents at the
        final round (ties -> the lowest label); payload = its members that
        were ALSO alive at round 0 (only they contribute local models);
        perrons = the per-round masked update matrices (with the plan's
        edge loss). Every plan of one structure dispatches to one degraded
        geometry, as in the reference one program serves them all."""
        with self._lock:
            cached = self._chaos_cache.get(plan)
            if cached is not None:
                return cached
            M = self.fitted.num_agents
            dt, dev = self.fitted.Xp.dtype, self.device
            alive = plan.alive_schedule(M, self.dac_iters)   # (iters, M)
            final = alive[-1] > 0.0
            if not final.any():
                raise ConsensusDiverged(
                    "fault plan drops every agent before readout")
            A_host = self.A.cpu().numpy()
            labels = connected_components(A_host, alive=final)
            uniq, counts = np.unique(labels[final], return_counts=True)
            comp = final & (labels == uniq[np.argmax(counts)])
            payload = (alive[0] > 0.0) & comp
            if not payload.any():
                raise ConsensusDiverged(
                    "no surviving agent holds a round-0 payload")
            # live-subgraph adjacency for DALE (nn_npae), with self-loops
            # on EVERY zero-degree node (dead ones too), as the reference
            # builds it
            A_live = A_host * np.outer(final, final)
            iso = np.flatnonzero(A_live.sum(axis=1) == 0)
            A_live[iso, iso] = 1.0
            edge = plan.edge_schedule(M, self.dac_iters)
            alive_t = torch.tensor(alive, dtype=dt, device=dev)
            chaos = {
                "alive_seq": alive_t,
                "readout": torch.tensor(comp, dtype=dt, device=dev),
                "payload": torch.tensor(payload, dtype=dt, device=dev),
                "corrupt": torch.tensor(plan.corrupt_mask(M), device=dev),
                "n_relay": torch.tensor(float(payload.sum()), dtype=dt,
                                        device=dev),
                "A_live": torch.tensor(A_live, device=dev),
                "perrons": masked_perrons(
                    self.A, alive_t,
                    edge_seq=None if edge is None
                    else torch.tensor(edge, device=dev)).to(dt),
                # the reference's degraded trace differs by whether the
                # plan carries edge masks: so does the geometry here
                "mode": "degraded" if edge is None else "degraded+edges",
            }
            meta = {"degraded": True,
                    "alive_agents": int(final.sum()),
                    "excluded_agents": int(M - payload.sum()),
                    "n_components": int(uniq.size)}
            self._chaos_cache[plan] = (chaos, meta)
            return chaos, meta

    def warm_slots(self, method: str, slots, *, input_dim: int | None = None,
                   dtype=None, fault_plan=None):
        """Serve one zero batch of every query-batch geometry in `slots`
        so a serving scheduler packing requests into those slots meets no
        new geometry on the request path (the reference pre-traces them).
        Pass the serving `fault_plan` to also warm the degraded geometry
        it will dispatch to."""
        D = self.fitted.Xp.shape[-1] if input_dim is None else int(input_dim)
        dt = self.fitted.Xp.dtype if dtype is None else dtype
        for s in slots:
            try:
                self.predict(method, torch.zeros((int(s), D), dtype=dt,
                                                 device=self.device),
                             fault_plan=fault_plan)
            except ConsensusDiverged:
                # the geometry is counted before the host-side guard
                # fires; a divergence on the synthetic warm batch is not a
                # serving failure
                continue

    def predict(self, method: str, Xs, fault_plan=None):
        """Serve one query batch -> (mean (Nt,), var (Nt,), info).

        info carries the worst-tile final consensus residuals
        ("dac_residual", "jor_residual", "dale_residual") of the
        decentralized methods, and the CBNN mask (M, Nt) of the nn_*
        methods.

        `fault_plan` (chaos.FaultPlan) injects the plan's consensus faults
        and serves over the surviving subgraph. The result is then either
        honestly DEGRADED (finite, computed over the largest live
        component, flagged info["degraded"]=True with the component
        census) or a typed `ConsensusDiverged` (non-finite output, or a
        consensus residual above `degraded_tol`). A consensus-free plan
        (stragglers, injected failures only) takes the exact path: bit
        for bit the result without a plan."""
        with span("engine.predict"):
            return self._predict(method, Xs, fault_plan)

    def _predict(self, method: str, Xs, fault_plan):
        if method not in self.METHODS:
            raise ValueError(f"unknown prediction method {method!r}; "
                             f"one of {self.METHODS}")
        if "grbcm" in method and (self.fitted_aug is None
                                  or self.fitted_comm is None):
            raise ValueError("grbcm methods need fitted_aug and fitted_comm")
        sparse = isinstance(self.fitted, SparseExperts)
        if sparse and method in self._DENSE_ONLY:
            raise ValueError(
                f"{method} needs the dense O(M^2 Ni^2) cross-Gram and is "
                f"not servable from sparse pseudo-representation experts; "
                f"use 'npae_sparse' (the low-rank NPAE path)")
        if method == "npae_sparse" and not sparse:
            raise ValueError(
                "npae_sparse serves from SparseExperts only — fit with "
                "FleetConfig(sparse_m=...) (or fit_sparse_experts) to build "
                "the pseudo-representation factors")
        chaos = meta = None
        if fault_plan is not None and not fault_plan.consensus_free:
            if method.startswith("cen_"):
                raise ValueError(
                    f"{method}: centralized references do not run consensus "
                    f"and cannot serve a fault plan with consensus faults")
            if method == "npae_sparse":
                raise ValueError(
                    "npae_sparse runs exact collectives (no averaging "
                    "consensus) and cannot serve a fault plan with "
                    "consensus faults")
            chaos, meta = self._chaos_arrays(fault_plan)
        Xs = self._queries(Xs)
        geometry = (method, tuple(Xs.shape), Xs.dtype,
                    None if chaos is None else chaos["mode"])
        with self._lock:
            if geometry not in self._served:
                # the reference traces once per new (method, query
                # geometry); its zero-recompile contract is asserted
                # against this count
                self._served.add(geometry)
                self._trace_count += 1
                self._traces_total.inc(engine="replicated", method=method)
        perq, red = map_query_tiles(
            lambda Xq: self._tile(method, Xq, chaos=chaos), Xs, self.chunk)
        info = dict(red)
        mask_t = perq.pop("mask_t", None)
        if mask_t is not None:
            info["mask"] = mask_t.T
        mean, var = perq["mean"], perq["var"]
        if chaos is not None:
            scrubbed = int(info.pop("scrubbed"))
            # guard the NETWORK consensus residuals (DAC/DALE), the part
            # degradation perturbs; the per-query JOR residual is the exact
            # path's masked math and stays reported, unguarded
            residual = max((float(info[k]) for k in
                            ("dac_residual", "dale_residual") if k in info),
                           default=0.0)
            finite = bool(torch.isfinite(mean).all()) \
                and bool(torch.isfinite(var).all())
            if not finite or not np.isfinite(residual) \
                    or residual > self.degraded_tol:
                self._diverged_total.inc(method=method)
                raise ConsensusDiverged(
                    f"{method}: degraded consensus did not converge "
                    f"(residual={residual:.3e}, tol={self.degraded_tol:.1e},"
                    f" finite={finite}) under fault plan {fault_plan!r}")
            self._degraded_total.inc(method=method)
            self._scrubbed_gauge.set(scrubbed)
            self._alive_gauge.set(meta["alive_agents"])
            info.update(meta)
            info["scrubbed_agents"] = scrubbed
        return mean, var, info

    @property
    def jit_cache_misses(self) -> int:
        """Distinct (method, query geometry) pairs served so far: what the
        reference's trace count counts. Flat across requests => every
        dispatch reused a served geometry."""
        return self._trace_count

    def set_diagnostics(self, flag: bool):
        """Toggle consensus-diagnostics capture: when on, `predict`'s info
        carries the FULL per-round DAC residual trajectory
        ("dac_residuals", the worst tile per round), and for npae /
        npae_star the JOR one ("jor_residuals"), beside the final scalars.
        Predictions are the same either way. As in the reference, where
        the flag is baked into the compiled programs, a toggle starts the
        served-geometry count afresh."""
        flag = bool(flag)
        if flag != self.diagnostics:
            self.diagnostics = flag
            with self._lock:
                self._served.clear()

    def swap_experts(self, fitted: FittedExperts):
        """Hot-swap the served factors (the streaming case:
        `OnlineExperts.to_fitted()` after observe/evict events).

        The replacement must match the served experts field for field in
        shape, dtype and device; the adjacency and everything else the
        engine holds stay as they are. Raises otherwise — a changed agent
        count or window is a membership change: use `rewire`."""
        if not isinstance(fitted, FittedExperts):
            raise TypeError(f"swap_experts: want FittedExperts, got "
                            f"{type(fitted).__name__}")

        def spec(t):
            return None if t is None else (t.shape, t.dtype, t.device)
        for name, new, old in zip(FittedExperts._fields, fitted,
                                  self.fitted):
            if spec(new) != spec(old):
                raise ValueError(
                    f"swap_experts: {name} changed from {spec(old)} to "
                    f"{spec(new)} (agent membership or window geometry) — "
                    f"use rewire()")
        self.fitted = fitted

    def rewire(self, A, fitted: FittedExperts | None = None):
        """Apply a membership or topology change (core.online.join /
        leave): a new adjacency and optionally a new fleet, on the engine's
        device. The consensus protocols read A at every call, so this is
        all it takes to re-sync them to the new graph."""
        experts = fitted if fitted is not None else self.fitted
        A = torch.as_tensor(A)
        if experts.num_agents != A.shape[0]:
            raise ValueError(f"rewire: {experts.num_agents} fitted agents "
                             f"vs adjacency for {A.shape[0]}")
        self.A = A.to(self.device, torch.float64)
        if fitted is not None:
            self.fitted = fitted.to(self.device)
        with self._lock:
            self._served.clear()     # the reference drops its programs
            # the fault arrays derive from A and M
            self._chaos_cache.clear()

    def posterior_means_streamed(self, Xs):
        """Per-agent streamed posterior means (M, Nt) via the fused
        Gram-matvec kernel — the O(Ni + Nt) mean-only path (O(m + Nt) for
        sparse experts, whose weights c ride their inducing inputs)."""
        f = self.fitted
        w = f.c if isinstance(f, SparseExperts) else f.alpha
        return stream_means(f.log_theta, f.Xp, w, self._queries(Xs))
