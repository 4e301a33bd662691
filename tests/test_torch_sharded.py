"""The port's agent-sharded fleet (launch.mesh, the ring collectives of
core.consensus, core.prediction.ShardedEngine, the sharded DEC-apx-GP
loop, and the fleet/launcher switches) against the JAX package on the
CPU, in float64, on meshes of k = 2, 4 and 8 CPU members.

Tolerances. The exact ring protocols (ring_allsum, ring_allmax,
ring_allgather) against their definitions: exact sums to 1e-12, maxima
and gathers bit for bit. The sharded DAC, JOR, DALE and flooding against
the reference's simulated protocols on the ring's graph (cycle_graph(k);
path_graph(2) for k = 2, the 2-ring's single edge): 1e-12 relative. The
ShardedEngine against the reference's replicated PredictionEngine at
ITERS = 800 DAC sweeps (both consensus protocols converged): 1e-6, the
reference's own gate (tests/test_sharded_serving.py), CBNN masks bit for
bit, and 1e-10 under consensus="exact". The sharded trainer against the
reference's simulated trainer on cycle_graph(k): rtol 1e-6, atol 1e-8,
the reference's tolerance (tests/test_training_admm.py). The fixtures
use the reference test's widths: M = 8 agents of 60 points in 2-D, 23
queries in tiles of 8.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.consensus import cycle_graph as j_cycle
from repro.core.consensus import dac as j_dac
from repro.core.consensus import dale as j_dale
from repro.core.consensus import flood as j_flood
from repro.core.consensus import jor as j_jor
from repro.core.consensus import path_graph as j_path
from repro.core import sparse as JS
from repro.core.gp import augment as j_augment
from repro.core.gp import communication_dataset as j_comm
from repro.core.gp import pack as j_pack
from repro.core.gp import stripe_partition as j_stripe
from repro.core.prediction import PredictionEngine as JEngine
from repro.core.prediction import fit_experts as j_fit_experts
from repro.core.training import train_dec_apx_gp as j_train_dec_apx
from repro.data import gp_sample_field, random_inputs
from repro_torch.core import sparse as S
from repro_torch.core.consensus import (dac_sharded, dac_sharded_residual,
                                        dale_sharded, flood_sharded,
                                        jor_sharded, ring_allgather,
                                        ring_allmax, ring_allsum,
                                        ring_allsum_masked)
from repro_torch.core.prediction import (ShardedEngine, expert_specs,
                                         fit_experts, shard_experts)
from repro_torch.core.training import train_dec_apx_gp_sharded
from repro_torch.fleet import FleetConfig, GPFleet
from repro_torch.launch import serve_gp
from repro_torch.launch.mesh import AgentMesh, make_agent_mesh

torch.set_num_threads(2)

M, NT, CHUNK, ITERS, ETA = 8, 23, 8, 800, 0.1
TRUE = ([1.2, 0.3], 1.3, 0.1)
LT = np.asarray(j_pack(*TRUE))
LT0 = np.asarray(j_pack([2.0, 0.5], 1.0, 1.0))
KS = (2, 4, 8)
DAC_METHODS = tuple(m for m in ShardedEngine.METHODS if m != "npae_sparse")
SPARSE_M = 12


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(got, want, tol):
    got, want = _n(got), _n(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


def mesh(k):
    return make_agent_mesh(M, devices=("cpu",) * k)


def _members(a, k):
    """Split a numpy (k, ...) array into one CPU tensor per member."""
    return [_t(x) for x in a[:k]]


@pytest.fixture(scope="module")
def data():
    X = random_inputs(jax.random.PRNGKey(0), 480)
    _, y = gp_sample_field(jax.random.PRNGKey(1), X, j_pack(*TRUE))
    Xp, yp = j_stripe(X, y, M)
    Xs = random_inputs(jax.random.PRNGKey(2), NT)
    Xc, yc = j_comm(jax.random.PRNGKey(3), Xp, yp)
    Xa, ya = j_augment(Xp, yp, Xc, yc)
    return {k: np.asarray(v) for k, v in dict(
        Xp=Xp, yp=yp, Xs=Xs, Xc=Xc, yc=yc, Xa=Xa, ya=ya).items()}


@pytest.fixture(scope="module")
def fitted(data):
    d = {k: _t(v) for k, v in data.items()}
    lt = _t(LT)
    return (fit_experts(lt, d["Xp"], d["yp"]),
            fit_experts(lt, d["Xa"], d["ya"]),
            fit_experts(lt, d["Xc"][None], d["yc"][None]))


@pytest.fixture(scope="module")
def reference(data):
    """The reference's replicated engine output for every DAC method."""
    jf = (j_fit_experts(LT, data["Xp"], data["yp"]),
          j_fit_experts(LT, data["Xa"], data["ya"]),
          j_fit_experts(LT, data["Xc"][None], data["yc"][None]))
    eng = JEngine(jf[0], j_path(M), chunk=CHUNK, dac_iters=ITERS,
                  eta_nn=ETA, fitted_aug=jf[1], fitted_comm=jf[2])
    out = {}
    for m in DAC_METHODS:
        mean, var, info = eng.predict(m, data["Xs"])
        out[m] = (np.asarray(mean), np.asarray(var),
                  np.asarray(info.get("mask", 0)))
    return out


@pytest.fixture(scope="module")
def engines(fitted):
    f, fa, fc = fitted
    return {k: ShardedEngine(f, mesh(k), chunk=CHUNK, dac_iters=ITERS,
                             eta_nn=ETA, fitted_aug=fa, fitted_comm=fc)
            for k in KS}


# -- the mesh ----------------------------------------------------------------

def test_make_agent_mesh_divisor_and_devices():
    assert make_agent_mesh(M, devices=("cpu",) * 8).shape["agents"] == 8
    assert make_agent_mesh(M, devices=("cpu",) * 6).shape["agents"] == 4
    assert make_agent_mesh(M, max_devices=3,
                           devices=("cpu",) * 8).shape["agents"] == 2
    assert make_agent_mesh(7, max_devices=4,
                           devices=("cpu",) * 8).shape["agents"] == 1
    m = make_agent_mesh(4, devices=("cpu",) * 4)
    assert isinstance(m, AgentMesh) and m.axis_names == ("agents",)
    assert all(d == torch.device("cpu") for d in m.devices)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            make_agent_mesh(4)


# -- ring collectives against their definitions ------------------------------

@pytest.mark.parametrize("k", KS)
def test_ring_allsum_allmax_allgather_exact(k):
    w = np.random.default_rng(k).standard_normal((k, 3, 2))
    ws = _members(w, k)
    for got in ring_allsum(ws):
        _close(got, w.sum(0), 1e-12)
    for got in ring_allmax(ws):
        assert np.array_equal(_n(got), w.max(0))
    gathered = ring_allgather(ws)
    for got in gathered:
        assert np.array_equal(_n(got), w)
    want, _ = j_flood(w, j_cycle(k) if k > 2 else j_path(2))
    for got in flood_sharded(ws):
        assert np.array_equal(_n(got), np.asarray(want))
    alive = [float(i % 2 == 0) for i in range(k)]
    for got in ring_allsum_masked(ws, alive):
        _close(got, (w * np.asarray(alive)[:, None, None]).sum(0), 1e-12)


@pytest.mark.parametrize("k", KS)
def test_dac_sharded_matches_simulated_ring(k):
    w0 = np.random.default_rng(10 + k).standard_normal((k, 5))
    A = j_cycle(k) if k > 2 else j_path(2)
    want, res = j_dac(w0, A, 60, 1.0 / 3.0)
    got, traj = dac_sharded(_members(w0, k), 60, with_residuals=True)
    _close(torch.stack(got), want, 1e-12)
    _close(traj, res, 1e-12)
    plain = dac_sharded(_members(w0, k), 60)
    assert all(torch.equal(a, b) for a, b in zip(plain, got))
    spread = dac_sharded_residual(got)
    assert all(float(s) == float(spread[0]) for s in spread)
    _close(spread[0], res[-1], 1e-12)


@pytest.mark.parametrize("k", KS)
def test_jor_dale_sharded_match_simulated(k):
    rng = np.random.default_rng(20 + k)
    B = rng.standard_normal((k, k))
    H = B @ B.T + k * np.eye(k)
    b = rng.standard_normal(k)
    omega = 1.0 / k
    q_sim, _ = j_jor(H, b, omega, 50)
    q = jor_sharded(_members(H, k), [_t(x) for x in b], omega, 50)
    _close(torch.stack(q), q_sim, 1e-12)
    A = j_cycle(k) if k > 2 else j_path(2)
    Q_sim, _ = j_dale(H, b, A, 80)
    Q = dale_sharded(_members(H, k), [_t(x) for x in b], 80)
    _close(torch.stack(Q), Q_sim, 1e-12)


# -- the sharded engine against the reference's replicated engine ------------

@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("method", DAC_METHODS)
def test_sharded_matches_reference_replicated(engines, reference, data, k,
                                              method):
    mean, var, info = engines[k].predict(method, _t(data["Xs"]))
    mr, vr, mask = reference[method]
    _close(mean, mr, 1e-6)
    _close(var, vr, 1e-6)
    if method.startswith("nn_"):
        assert np.array_equal(_n(info["mask"]), mask)
    assert float(info["dac_residual"]) < 1e-8


@pytest.mark.parametrize("method", ("rbcm", "nn_gpoe", "grbcm"))
def test_exact_consensus_matches_reference(fitted, reference, data, method):
    f, fa, fc = fitted
    sh = ShardedEngine(f, mesh(4), chunk=CHUNK, eta_nn=ETA,
                       consensus="exact", fitted_aug=fa, fitted_comm=fc)
    mean, var, info = sh.predict(method, _t(data["Xs"]))
    _close(mean, reference[method][0], 1e-10)
    _close(var, reference[method][1], 1e-10)
    assert float(info["dac_residual"]) == 0.0


@pytest.mark.parametrize("method", ("rbcm", "grbcm", "nn_grbcm"))
def test_streamed_means_match_reference(fitted, data, method):
    """stream_mean=True (the card's mean path, here its plain version):
    every member's experts, the communication expert's too, against the
    reference's replicated engine with stream_mean=True."""
    jf = (j_fit_experts(LT, data["Xp"], data["yp"]),
          j_fit_experts(LT, data["Xa"], data["ya"]),
          j_fit_experts(LT, data["Xc"][None], data["yc"][None]))
    jeng = JEngine(jf[0], j_path(M), chunk=CHUNK, dac_iters=ITERS,
                   eta_nn=ETA, fitted_aug=jf[1], fitted_comm=jf[2],
                   stream_mean=True)
    mr, vr, _ = jeng.predict(method, data["Xs"])
    f, fa, fc = fitted
    sh = ShardedEngine(f, mesh(4), chunk=CHUNK, dac_iters=ITERS, eta_nn=ETA,
                       fitted_aug=fa, fitted_comm=fc, stream_mean=True)
    mean, var, _ = sh.predict(method, _t(data["Xs"]))
    _close(mean, mr, 1e-6)
    _close(var, vr, 1e-6)


@pytest.mark.parametrize("k", KS)
def test_npae_sparse_sharded_matches_reference(data, k):
    Zj = JS.select_inducing(data["Xp"], SPARSE_M, "stride")
    js = JS.fit_sparse_experts(LT, data["Xp"], data["yp"], Zj)
    jeng = JEngine(js, j_path(M), chunk=CHUNK)
    mr, vr, _ = jeng.predict("npae_sparse", data["Xs"])
    sp = S.fit_sparse_experts(_t(LT), _t(data["Xp"]), _t(data["yp"]),
                              _t(np.asarray(Zj)))
    sh = ShardedEngine(sp, mesh(k), chunk=CHUNK)
    mean, var, info = sh.predict("npae_sparse", _t(data["Xs"]))
    _close(mean, mr, 1e-6)
    _close(var, vr, 1e-6)
    assert float(info["dac_residual"]) == 0.0
    rbcm = sh.predict("rbcm", _t(data["Xs"]))[0]
    _close(rbcm, jeng.predict("rbcm", data["Xs"])[0], 1e-6)


def test_sharded_rejects_npae_family_and_bad_geometry(engines, fitted, data):
    sh = engines[4]
    Xs = _t(data["Xs"])
    for method in ("npae", "npae_star", "nn_npae", "cen_rbcm"):
        with pytest.raises(ValueError, match="sharded method"):
            sh.predict(method, Xs)
    with pytest.raises(ValueError, match="SparseExperts"):
        sh.predict("npae_sparse", Xs)
    with pytest.raises(ValueError):
        sh.predict_routed("rbcm", Xs)            # routing is CBNN-only
    f = fitted[0]
    odd = f._replace(Xp=f.Xp[:5], yp=f.yp[:5], L=f.L[:5], alpha=f.alpha[:5])
    with pytest.raises(ValueError, match="shard"):
        ShardedEngine(odd, mesh(4))
    with pytest.raises(ValueError, match="Kcross"):
        expert_specs(f._replace(Kcross=torch.zeros(M, M, 2, 2)), "agents")
    blocks = shard_experts(f, mesh(4))
    assert len(blocks) == 4 and blocks[1].Xp.shape == (2, 60, 2)
    assert torch.equal(blocks[1].L, f.L[2:4])
    comm = shard_experts(fitted[2], mesh(4), replicate=True)
    assert all(torch.equal(c.Xp, fitted[2].Xp) for c in comm)


def test_swap_experts_and_geometry_count(fitted, data):
    f, _, _ = fitted
    Xs = _t(data["Xs"])
    sh = ShardedEngine(f, mesh(4), chunk=CHUNK, dac_iters=50)
    m1, _, _ = sh.predict("poe", Xs)
    n = sh.jit_cache_misses
    sh.swap_experts(f._replace(yp=2.0 * f.yp, alpha=2.0 * f.alpha))
    m2, _, _ = sh.predict("poe", Xs)
    assert sh.jit_cache_misses == n == 1
    _close(m2, 2.0 * _n(m1), 1e-8)                      # PoE mean is linear
    Ni = f.Xp.shape[1]
    sh.swap_experts(f._replace(Kcross=torch.zeros(M, M, Ni, Ni)))
    with pytest.raises(ValueError, match="shapes changed"):
        sh.swap_experts(f._replace(Xp=f.Xp[:, :10], yp=f.yp[:, :10],
                                   L=f.L[:, :10, :10], alpha=f.alpha[:, :10]))
    sh.set_diagnostics(True)
    mean, _, info = sh.predict("poe", Xs)
    assert info["dac_residuals"].shape == (50,)
    sh.set_diagnostics(False)
    _close(sh.predict("poe", Xs)[0], mean, 0.0)
    sh.warm_slots("rbcm", (8, 16))
    assert sh.jit_cache_misses == 5      # poe x 3 (two toggles), 2 slots


# -- CBNN routing ---------------------------------------------------------------

@pytest.fixture(scope="module")
def routed_case():
    """The reference test's shard-interior queries at tight eta_nn: short
    lengthscales, 640 points, queries near the agents' centroids."""
    lt = j_pack([0.08, 0.08], 1.3, 0.1)
    X = random_inputs(jax.random.PRNGKey(0), 640)
    _, y = gp_sample_field(jax.random.PRNGKey(1), X, lt)
    Xp, yp = j_stripe(X, y, M)
    cents = np.asarray(Xp).mean(1)
    noise = 0.01 * np.asarray(jax.random.normal(jax.random.PRNGKey(5),
                                                (3,) + cents.shape))
    Xs = np.concatenate([cents + n for n in noise])
    rep = JEngine(j_fit_experts(lt, Xp, yp), j_path(M), chunk=CHUNK,
                  dac_iters=1500, eta_nn=0.8)
    ref = {m: rep.predict(m, Xs) for m in ("nn_rbcm", "nn_gpoe", "nn_poe")}
    f = fit_experts(_t(np.asarray(lt)), _t(np.asarray(Xp)),
                    _t(np.asarray(yp)))
    return f, Xs, {m: tuple(np.asarray(x) for x in (r[0], r[1],
                                                     r[2]["mask"]))
                   for m, r in ref.items()}


@pytest.mark.parametrize("k", KS)
def test_routed_matches_reference_on_shard_local_participants(routed_case,
                                                              k):
    f, Xs, ref = routed_case
    sh = ShardedEngine(f, mesh(k), chunk=CHUNK, dac_iters=1500, eta_nn=0.8)
    for method, (mr, vr, mask) in ref.items():
        mean, var, info = sh.predict_routed(method, Xs)
        _close(mean, mr, 1e-6)
        _close(var, vr, 1e-6)
        assert np.array_equal(_n(info["n_selected"]), mask.sum(0))
        assert info["batch_per_shard"] % CHUNK == 0
        assert info["shard"].shape == (Xs.shape[0],)


def test_routed_is_permutation_invariant(engines, data):
    sh = engines[8]
    Xs = data["Xs"]
    mean, var, info = sh.predict_routed("nn_rbcm", Xs)
    assert mean.shape == (NT,) and var.shape == (NT,)
    assert np.all(_n(info["n_selected"]) >= 1)
    perm = np.random.default_rng(0).permutation(NT)
    mean_p, _, _ = sh.predict_routed("nn_rbcm", Xs[perm])
    _close(mean_p, _n(mean)[perm], 1e-10)


# -- sharded training ------------------------------------------------------------

@pytest.mark.parametrize("k", (2, 4))
def test_dec_apx_sharded_matches_simulated_cycle(k):
    X = random_inputs(jax.random.PRNGKey(0), 100 * k)
    _, y = gp_sample_field(jax.random.PRNGKey(1), X, j_pack(*TRUE))
    Xp, yp = (np.asarray(a) for a in j_stripe(X, y, k))
    th_sim, info_sim = j_train_dec_apx(LT0, Xp, yp, j_cycle(k), iters=40)
    th, info = train_dec_apx_gp_sharded(
        make_agent_mesh(k, devices=("cpu",) * k), "agents", _t(LT0),
        _t(Xp), _t(yp), iters=40)
    np.testing.assert_allclose(_n(th), np.asarray(th_sim), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(_n(info["residuals"]),
                               np.asarray(info_sim["residuals"]),
                               rtol=1e-5, atol=1e-8)
    assert info["p"].shape == th.shape


# -- the fleet and the launcher -----------------------------------------------------

def test_fleet_sharded_and_routed_switches(data, reference):
    Xp, yp, Xs = _t(data["Xp"]), _t(data["yp"]), _t(data["Xs"])
    cfg = FleetConfig(num_agents=M, method="nn_rbcm", chunk=CHUNK,
                      dac_iters=ITERS, eta_nn=ETA)
    fleet = GPFleet(cfg, device="cpu").fit(Xp, yp, log_theta0=LT,
                                           train=False)
    fleet.shard(mesh=mesh(4))
    assert fleet.health()["sharded"] and fleet.metrics()["fleet"]["sharded"]
    mean, var, info = fleet.predict(Xs)
    assert fleet.engine.ndev == 4
    _close(mean, reference["nn_rbcm"][0], 1e-6)
    assert np.array_equal(_n(info["mask"]), reference["nn_rbcm"][2])
    fleet.shard(routed=True)
    assert fleet.config.routed
    _, _, info = fleet.predict(Xs)
    assert "n_selected" in info
    with pytest.raises(ValueError, match="replicated engine only"):
        fleet.predict(Xs, method="cen_rbcm")
    from repro_torch.chaos import Dropout, FaultPlan
    free = fleet.predict(Xs, method="rbcm",
                         fault_plan=FaultPlan(straggle_every=2, fail_every=3))
    assert torch.equal(free[0], fleet.predict(Xs, method="rbcm")[0])
    with pytest.raises(ValueError, match="replicated engine only"):
        fleet.predict(Xs, method="rbcm",
                      fault_plan=FaultPlan(dropouts=(Dropout(0),)))
    for kw in (dict(sharded=True, method="npae"),
               dict(routed=True), dict(sharded=True, routed=True,
                                       method="rbcm"),
               dict(sharded=True, cache_cross=True)):
        with pytest.raises(ValueError):
            GPFleet(FleetConfig(**kw), device="cpu")
    fl = GPFleet(FleetConfig(num_agents=M, sharded=True, routed=True,
                             method="nn_gpoe", chunk=CHUNK),
                 device="cpu").fit(Xp, yp, log_theta0=LT, train=False)
    assert fl.engine.ndev == 1            # the CPU fleet's default mesh
    assert fl.predict(Xs)[0].shape == (NT,)


def test_dec_apx_sharded_trainer_mesh_size(data):
    Xp, yp = _t(data["Xp"][:4]), _t(data["yp"][:4])
    cfg = FleetConfig(trainer="dec-apx-sharded", admm_iters=3)
    with pytest.raises(ValueError, match="ONE agent per mesh member"):
        GPFleet(cfg, device="cpu").fit(Xp, yp, log_theta0=LT0)
    fleet = GPFleet(cfg, mesh=make_agent_mesh(4, devices=("cpu",) * 4),
                    device="cpu").fit(Xp, yp, log_theta0=LT0)
    th_sim, _ = j_train_dec_apx(LT0, data["Xp"][:4], data["yp"][:4],
                                j_cycle(4), iters=3)
    np.testing.assert_allclose(_n(fleet.thetas), np.asarray(th_sim),
                               rtol=1e-6, atol=1e-8)
    _close(fleet.log_theta, np.asarray(th_sim).mean(0), 1e-12)


def test_serve_gp_sharded_routed_on_the_cpu(capsys):
    serve_gp.main(["--device", "cpu", "--agents", "4", "--per-agent", "64",
                   "--method", "nn-rbcm", "--sharded", "--routed",
                   "--requests", "4", "--batch", "64", "--chunk", "32"])
    out = capsys.readouterr().out
    assert "sharded over 1 device(s), CBNN-routed" in out
    assert "nn_rbcm: served" in out
    with pytest.raises(SystemExit):
        serve_gp.main(["--device", "cpu", "--method", "npae", "--sharded"])
    assert "not servable on the agent-sharded engine" in \
        capsys.readouterr().err
