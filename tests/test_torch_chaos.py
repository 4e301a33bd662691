"""Parity of the port's chaos layer (repro_torch.chaos, consensus.degraded,
the engine's fault plans and the fleet's degraded mode) with the JAX
package, on the same float64 numpy inputs.

Tolerances. The plan schedules are numpy in both packages: array-equal.
Degraded consensus and the engine under plans: 1e-9 relative to
max|reference| (the port sweeps precomputed per-round matrices where the
reference updates w + eps (A_t w - d_t w); the same float64 arithmetic
in another order). The degradation census is equal; the consensus
residuals agree within 1e-9 (they sit at the payloads' rounding, a few
1e-13, or above). Consensus-free plans are bit for bit the result without
a plan.

The engine fixture is the reference test's (tests/test_chaos.py): M = 8
agents of 24 points in 1-D on random_connected_graph(8, 0.4, seed=1),
chunk 16, 600 DAC sweeps, with augmented and communication experts. Each
reference run is computed once, in a module-scoped fixture.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.chaos import Dropout as JDropout
from repro.chaos import FaultPlan as JFaultPlan
from repro.chaos import membership_events as jmembership_events
from repro.core.consensus import dac_masked as jdac_masked
from repro.core.consensus import dac_masked_sums as jdac_masked_sums
from repro.core.consensus import path_graph as jpath_graph
from repro.core.consensus import random_connected_graph as jrandom_graph
from repro.core.prediction.engine import PredictionEngine as JEngine
from repro.core.prediction.engine import fit_experts as jfit_experts
from repro_torch.chaos import (Dropout, FaultInjected, FaultPlan,
                               membership_events, wrap_predict_fn)
from repro_torch.core.consensus import (ConsensusDiverged, complete_graph,
                                        dac, dac_masked, dac_masked_sums,
                                        masked_perrons, path_graph,
                                        random_connected_graph)
from repro_torch.core.prediction import PredictionEngine, fit_experts
from repro_torch.core.sparse import fit_sparse_experts, select_inducing
from repro_torch.fleet import FleetConfig, FleetDegraded, GPFleet

torch.set_num_threads(2)

TOL = 1e-9
M, NI, D, NT = 8, 24, 1, 37
DAC_ITERS = 600
LOG_THETA = np.log([0.7, 1.0, 0.1])
METHODS = ("poe", "gpoe", "bcm", "rbcm", "grbcm", "npae", "npae_star",
           "nn_poe", "nn_gpoe", "nn_bcm", "nn_rbcm", "nn_grbcm", "nn_npae")
# (name, FaultPlan kwargs, graph): the reference test's scenarios
PLANS = {
    "round0": (dict(dropouts=((2, 0),)), "random"),
    "partition": (dict(dropouts=((1, 0),)), "path"),
    "midrun_edges": (dict(seed=7, dropouts=((3, 240, 480),),
                          edge_loss=0.05), "random"),
    "nan_agent": (dict(nan_agents=(5,)), "random"),
    "mixed": (dict(seed=7, dropouts=((1, 0), (3, 240)), nan_agents=(5,),
                   edge_loss=0.05), "random"),
}
CASES = [(m, "round0") for m in METHODS] + [
    (m, p) for m in ("rbcm", "nn_npae")
    for p in ("partition", "midrun_edges", "nan_agent", "mixed")]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def _plans(kw):
    dropouts = kw.get("dropouts", ())
    rest = {k: v for k, v in kw.items() if k != "dropouts"}
    return (JFaultPlan(dropouts=tuple(JDropout(*d) for d in dropouts),
                       **rest),
            FaultPlan(dropouts=tuple(Dropout(*d) for d in dropouts), **rest))


# ---------------------------------------------------------------------------
# FaultPlan schedules: the same numpy code in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_plan_schedules_equal_the_reference(seed):
    kw = dict(seed=seed, dropouts=((1, 0), (3, 4, 9), (5, 2)),
              edge_loss=0.3, nan_agents=(2, 6))
    jp, tp = _plans(kw)
    np.testing.assert_array_equal(tp.alive_schedule(M, 12),
                                  jp.alive_schedule(M, 12))
    np.testing.assert_array_equal(tp.final_alive(M, 12),
                                  jp.final_alive(M, 12))
    np.testing.assert_array_equal(tp.edge_schedule(M, 12),
                                  jp.edge_schedule(M, 12))
    np.testing.assert_array_equal(tp.corrupt_mask(M), jp.corrupt_mask(M))
    for steps in (3, 6, 12):
        assert membership_events(tp, M, steps) == \
            jmembership_events(jp, M, steps)
    assert (tp.consensus_free, tp.empty) == (jp.consensus_free, jp.empty)
    assert FaultPlan(seed=seed).edge_schedule(M, 5) is None


def test_plan_validation_and_serving_faults():
    with pytest.raises(ValueError):
        FaultPlan(edge_loss=1.0)
    with pytest.raises(ValueError):
        FaultPlan(dropouts=(Dropout(9),)).alive_schedule(M, 4)
    naps = []
    wrapped = wrap_predict_fn(lambda Xs: Xs, FaultPlan(
        straggle_every=2, straggle_ms=4.0, fail_every=3), sleep=naps.append)
    out = []
    for i in range(6):
        try:
            wrapped(i)
            out.append("ok")
        except FaultInjected:
            out.append("fail")
    assert out == ["ok", "ok", "fail", "ok", "ok", "fail"]
    assert naps == [4e-3, 4e-3] and wrapped.calls["n"] == 6


# ---------------------------------------------------------------------------
# Degraded consensus numerics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,graph", [
    (dict(dropouts=((2, 0),)), "complete"),
    (dict(dropouts=((4, 10),)), "complete"),
    (dict(seed=3, dropouts=((1, 5, 40), (6, 0)), edge_loss=0.2), "random"),
    (dict(dropouts=((1, 0),)), "path"),
])
def test_dac_masked_and_sums_match_the_reference(kw, graph):
    rng = np.random.default_rng(len(str(kw)))
    w0 = rng.standard_normal((M, 3))
    A = {"complete": np.ones((M, M)) - np.eye(M),
         "random": np.asarray(jrandom_graph(M, 0.4, seed=1)),
         "path": np.asarray(jpath_graph(M))}[graph]
    jp, tp = _plans(kw)
    iters = 80
    alive = tp.alive_schedule(M, iters)
    edge = tp.edge_schedule(M, iters)
    jw, jres = jdac_masked(jnp.asarray(w0), jnp.asarray(A),
                           jnp.asarray(alive),
                           edge_seq=None if edge is None
                           else jnp.asarray(edge))
    tw, tres = dac_masked(_t(w0), _t(A), _t(alive),
                          edge_seq=None if edge is None else _t(edge))
    _close(tw, jw)
    np.testing.assert_allclose(tres, jres, rtol=0, atol=TOL)
    readout = tp.final_alive(M, iters).astype(float)
    n_relay = float(readout.sum())
    js, jr = jdac_masked_sums(jnp.asarray(w0), jnp.asarray(A),
                              jnp.asarray(alive), jnp.asarray(readout),
                              jnp.asarray(n_relay),
                              edge_seq=None if edge is None
                              else jnp.asarray(edge))
    ts, tr = dac_masked_sums(_t(w0), _t(A), _t(alive), _t(readout),
                             n_relay, edge_seq=None if edge is None
                             else _t(edge))
    _close(ts, js)
    np.testing.assert_allclose(tr, jr, rtol=0, atol=TOL)


def test_dead_agent_rows_are_unit_and_freeze_its_state():
    """W_t's row of an agent dead in round t is e_i, and a dead agent's
    state is bit for bit the one it held at dropout (no `where` needed
    with finite payloads), while the survivors reach consensus."""
    rng = np.random.default_rng(2)
    A = complete_graph(M)
    w0 = _t(rng.standard_normal((M, 2)))
    alive = _t(FaultPlan(dropouts=(Dropout(4, at=10),)).alive_schedule(
        M, 200))
    W = masked_perrons(A, alive)
    assert torch.equal(W[10:, 4], torch.eye(M, dtype=W.dtype)[4].expand(
        190, M))
    w, _ = dac_masked(w0, A, alive)
    w10, _ = dac_masked(w0, A, alive[:10])
    assert torch.equal(w[4], w10[4])
    live = torch.cat([w[:4], w[5:]])
    assert float((live.amax(0) - live.amin(0)).max()) < 1e-9


def test_round0_dropout_sums_are_exact_masked_aggregation():
    rng = np.random.default_rng(1)
    w0 = _t(rng.standard_normal((M, 2)))
    plan = FaultPlan(dropouts=(Dropout(2, at=0),))
    alive = _t(plan.alive_schedule(M, 500))
    readout = _t(plan.final_alive(M, 500).astype(float))
    sums, res = dac_masked_sums(w0, complete_graph(M), alive, readout, 7.0)
    keep = torch.arange(M) != 2
    torch.testing.assert_close(sums, w0[keep].sum(0), rtol=0, atol=1e-12)
    assert float(res[-1]) < 1e-12


def test_all_alive_masked_dac_is_dac():
    rng = np.random.default_rng(0)
    A = random_connected_graph(M, 0.4, seed=1)
    w0 = _t(rng.standard_normal((M, 3)))
    w_m, _ = dac_masked(w0, A, torch.ones(300, M, dtype=torch.float64))
    w_e, _ = dac(w0, A, 300)
    _close(w_m, w_e, 1e-12)


# ---------------------------------------------------------------------------
# The engine under fault plans (the reference test's fleet)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet_data():
    rng = np.random.default_rng(0)
    X = rng.uniform(-3, 3, (M, NI, D))
    y = np.sin(X.sum(-1)) + 0.05 * rng.standard_normal((M, NI))
    Xc = rng.uniform(-3, 3, (NI, D))
    yc = np.sin(Xc.sum(-1)) + 0.05 * rng.standard_normal(NI)
    Xa = np.concatenate([np.broadcast_to(Xc, (M, NI, D)), X], axis=1)
    ya = np.concatenate([np.broadcast_to(yc, (M, NI)), y], axis=1)
    Xs = rng.uniform(-3, 3, (NT, D))
    graphs = {"random": np.asarray(jrandom_graph(M, 0.4, seed=1)),
              "path": np.asarray(jpath_graph(M))}
    return dict(X=X, y=y, Xc=Xc, yc=yc, Xa=Xa, ya=ya, Xs=Xs, graphs=graphs)


def _engines(d, graph):
    A = d["graphs"][graph]
    lt = jnp.asarray(LOG_THETA)
    jeng = JEngine(jfit_experts(lt, jnp.asarray(d["X"]), jnp.asarray(d["y"])),
                   jnp.asarray(A), chunk=16, dac_iters=DAC_ITERS,
                   fitted_aug=jfit_experts(lt, jnp.asarray(d["Xa"]),
                                           jnp.asarray(d["ya"])),
                   fitted_comm=jfit_experts(lt, jnp.asarray(d["Xc"])[None],
                                            jnp.asarray(d["yc"])[None]))
    tl = _t(LOG_THETA)
    teng = PredictionEngine(
        fit_experts(tl, _t(d["X"]), _t(d["y"])), _t(A), chunk=16,
        dac_iters=DAC_ITERS,
        fitted_aug=fit_experts(tl, _t(d["Xa"]), _t(d["ya"])),
        fitted_comm=fit_experts(tl, _t(d["Xc"])[None], _t(d["yc"])[None]),
        device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def engines(fleet_data):
    return {g: _engines(fleet_data, g) for g in ("random", "path")}


@pytest.fixture(scope="module")
def reference_runs(fleet_data, engines):
    """Every CASES (method, plan) through the reference, once."""
    out = {}
    Xs = jnp.asarray(fleet_data["Xs"])
    for method, name in CASES:
        kw, graph = PLANS[name]
        m, v, info = engines[graph][0].predict(method, Xs,
                                               fault_plan=_plans(kw)[0])
        out[method, name] = (np.asarray(m), np.asarray(v),
                             {k: np.asarray(x) for k, x in info.items()})
    return out


CENSUS = ("degraded", "alive_agents", "excluded_agents", "n_components",
          "scrubbed_agents")


@pytest.mark.parametrize("method,plan", CASES)
def test_engine_under_plan_matches_the_reference(fleet_data, engines,
                                                 reference_runs, method,
                                                 plan):
    kw, graph = PLANS[plan]
    jm, jv, jinfo = reference_runs[method, plan]
    tm, tv, tinfo = engines[graph][1].predict(
        method, _t(fleet_data["Xs"]), fault_plan=_plans(kw)[1])
    assert bool(torch.isfinite(tm).all()) and bool(torch.isfinite(tv).all())
    _close(tm, jm)
    _close(tv, jv)
    for k in CENSUS:
        assert tinfo[k] == jinfo[k].item(), k
    for k in ("dac_residual", "dale_residual", "jor_residual"):
        assert (k in tinfo) == (k in jinfo), k
        if k in jinfo:
            assert abs(float(tinfo[k]) - float(jinfo[k])) <= TOL, k
    if "mask" in jinfo:
        np.testing.assert_array_equal(tinfo["mask"].numpy(), jinfo["mask"])


@pytest.mark.parametrize("method", METHODS)
def test_consensus_free_plan_is_bitwise_identical(fleet_data, engines,
                                                  method):
    eng = engines["random"][1]
    Xs = _t(fleet_data["Xs"])
    m0, v0, _ = eng.predict(method, Xs)
    m1, v1, info = eng.predict(method, Xs, fault_plan=FaultPlan(
        straggle_every=2, straggle_ms=1.0, fail_every=5))
    assert torch.equal(m0, m1) and torch.equal(v0, v1)
    assert "degraded" not in info


def test_plans_share_one_degraded_geometry(fleet_data, engines):
    """Every plan of one structure serves from one degraded geometry
    (counted apart from the exact one), as the reference's plans share one
    trace; a plan without edge loss is another structure."""
    eng = engines["random"][1]
    Xs = _t(fleet_data["Xs"])[:29]          # a geometry no other test serves
    eng.predict("poe", Xs)
    n0 = eng.jit_cache_misses
    eng.predict("poe", Xs, fault_plan=FaultPlan(
        seed=7, dropouts=(Dropout(1),), nan_agents=(5,), edge_loss=0.05))
    assert eng.jit_cache_misses == n0 + 1
    eng.predict("poe", Xs, fault_plan=FaultPlan(
        seed=9, dropouts=(Dropout(4, at=50),), nan_agents=(0,),
        edge_loss=0.05))
    assert eng.jit_cache_misses == n0 + 1
    eng.predict("poe", Xs, fault_plan=FaultPlan(dropouts=(Dropout(4),)))
    assert eng.jit_cache_misses == n0 + 2
    eng.warm_slots("poe", (17, 31), fault_plan=FaultPlan(
        dropouts=(Dropout(4),)))
    assert eng.jit_cache_misses == n0 + 4


def test_engine_rejections_and_total_dropout(fleet_data, engines):
    eng = engines["random"][1]
    Xs = _t(fleet_data["Xs"])
    plan = FaultPlan(dropouts=(Dropout(1),))
    with pytest.raises(ValueError, match="centralized"):
        eng.predict("cen_poe", Xs, fault_plan=plan)
    with pytest.raises(ConsensusDiverged):
        eng.predict("poe", Xs, fault_plan=FaultPlan(
            dropouts=tuple(Dropout(i) for i in range(M))))
    # a consensus-free plan reaches the centralized references unchanged
    m0 = eng.predict("cen_rbcm", Xs)[0]
    m1 = eng.predict("cen_rbcm", Xs, fault_plan=FaultPlan(fail_every=2))[0]
    assert torch.equal(m0, m1)
    fd = fleet_data
    tl = _t(LOG_THETA)
    Xp = _t(fd["X"])
    sparse = PredictionEngine(
        fit_sparse_experts(tl, Xp, _t(fd["y"]), select_inducing(Xp, 6)),
        _t(fd["graphs"]["random"]), chunk=16, dac_iters=20, device="cpu")
    with pytest.raises(ValueError, match="npae_sparse"):
        sparse.predict("npae_sparse", Xs, fault_plan=plan)


def test_rewire_drops_the_plan_cache(fleet_data, engines):
    eng = engines["path"][1]
    plan = FaultPlan(dropouts=(Dropout(1),))
    eng.predict("rbcm", _t(fleet_data["Xs"]), fault_plan=plan)
    assert plan in eng._chaos_cache
    eng.rewire(eng.A.cpu())
    assert not eng._chaos_cache and eng.jit_cache_misses >= 0


# ---------------------------------------------------------------------------
# Fleet facade: typed degradation, health
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet():
    rng = np.random.default_rng(5)
    Xp = rng.uniform(-3, 3, (M, 24, 1))
    yp = np.sin(Xp.sum(-1)) + 0.05 * rng.standard_normal((M, 24))
    cfg = FleetConfig(num_agents=M, method="rbcm", chunk=16, dac_iters=600,
                      input_dim=1, theta0=(0.7, 1.0, 0.1))
    return GPFleet(cfg, device="cpu").fit(_t(Xp), _t(yp), train=False)


def test_fleet_degraded_is_opt_in(fleet):
    Xs = torch.linspace(-3, 3, 9, dtype=torch.float64)[:, None]
    plan = FaultPlan(dropouts=(Dropout(1),))
    with pytest.raises(FleetDegraded) as exc:
        fleet.predict(Xs, fault_plan=plan)
    assert exc.value.info["degraded"] is True
    mu, var, info = fleet.predict(Xs, fault_plan=plan, allow_degraded=True)
    assert torch.equal(mu, exc.value.result[0])
    assert bool(torch.isfinite(mu).all()) and info["degraded"] is True
    m0 = fleet.predict(Xs)[0]
    assert torch.equal(m0, fleet.predict(Xs, fault_plan=FaultPlan(
        straggle_every=1, straggle_ms=1.0))[0])


def test_fleet_health_surface(fleet):
    Xs = torch.linspace(-3, 3, 9, dtype=torch.float64)[:, None]
    before = fleet.health()
    fleet.predict(Xs, fault_plan=FaultPlan(dropouts=(Dropout(1),)),
                  allow_degraded=True)
    # agent 0 (no round-0 payload) rejoins the relay one sweep before the
    # readout with its zero state: the residual guard trips
    with pytest.raises(ConsensusDiverged):
        fleet.predict(Xs, fault_plan=FaultPlan(dropouts=(
            Dropout(0, at=0, until=599),)), allow_degraded=True)
    h = fleet.health()
    assert set(h) == {"num_agents", "is_fitted", "sharded",
                      "graph_connected", "graph_components",
                      "degraded_predictions", "diverged_predictions",
                      "last_degraded"}
    assert h["num_agents"] == M and h["is_fitted"] and not h["sharded"]
    assert h["graph_connected"] is True and h["graph_components"] == 1
    assert h["degraded_predictions"] >= before["degraded_predictions"] + 1
    assert h["diverged_predictions"] >= before["diverged_predictions"] + 1
    # the path loses agent 1: agent 0 is cut off, {2..7} is served
    assert h["last_degraded"] == {"alive_agents": M - 1,
                                  "excluded_agents": 2, "n_components": 2,
                                  "scrubbed_agents": 0}
