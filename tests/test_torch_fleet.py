"""The port's fleet layer (repro_torch.fleet) and launcher against the JAX
package: config fields and JSON, capability validation, and the whole
slice end to end — GPFleet.fit(train=False).predict on the same float64
arrays — to 1e-9 relative (same algorithms, different LAPACK/BLAS
rounding; see tests/test_torch_prediction.py).
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fleet import FleetConfig as JFleetConfig
from repro.fleet import GPFleet as JGPFleet
from repro_torch.fleet import (METHODS, FleetConfig, GPFleet, get_method,
                               validate_config)
from repro_torch.launch import serve_gp
from repro_torch.launch.mesh import make_agent_mesh
from repro_torch.obs import TraceRecorder

torch.set_num_threads(2)

TOL = 1e-9
LOG_THETA = np.log([1.2, 0.3, 1.3, 0.1])


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    X = rng.uniform(0, 2, (4 * 40, 2))
    X = X[np.argsort(X[:, 0])]
    y = np.cos(2 * X[:, 0] + X[:, 1]) + 0.1 * rng.normal(size=len(X))
    return X.reshape(4, 40, 2), y.reshape(4, 40), rng.uniform(0, 2, (45, 2))


def test_config_fields_defaults_and_json_match_reference():
    ours = {f.name: f.default for f in dataclasses.fields(FleetConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JFleetConfig)}
    assert ours == theirs
    assert json.loads(FleetConfig().to_json()) == \
        json.loads(JFleetConfig().to_json())
    cfg = JFleetConfig(num_agents=6, graph="random", method="gpoe",
                       stream_mean=True)
    assert FleetConfig.from_json(cfg.to_json()).to_dict() == cfg.to_dict()
    with pytest.raises(ValueError, match="theta0"):
        FleetConfig(input_dim=3)


@pytest.mark.parametrize("graph", ["path", "cycle", "complete", "random"])
@pytest.mark.parametrize("stream_mean", [False, True])
def test_fleet_rbcm_matches_reference(data, graph, stream_mean):
    """The slice end to end: fit at known theta, serve rBCM on a ragged
    query batch."""
    Xp, yp, Xs = data
    kw = dict(graph=graph, chunk=16, dac_iters=150, stream_mean=stream_mean)
    fleet = GPFleet(FleetConfig(**kw), device="cpu").fit(
        Xp, yp, log_theta0=LOG_THETA, train=False)
    mean, var, info = fleet.predict(Xs)
    jfleet = JGPFleet(JFleetConfig(**kw)).fit(
        jnp.asarray(Xp), jnp.asarray(yp),
        log_theta0=jnp.asarray(LOG_THETA), train=False)
    jmean, jvar, _ = jfleet.predict(jnp.asarray(Xs))
    assert mean.dtype == torch.float64 and mean.device.type == "cpu"
    _close(mean, jmean)
    _close(var, jvar)
    _close(fleet.predict(Xs, method="cen_rbcm")[0],
           jfleet.predict(jnp.asarray(Xs), method="cen_rbcm")[0])


def test_fleet_default_theta_is_config_theta0(data):
    Xp, yp, Xs = data
    fleet = GPFleet(FleetConfig(), device="cpu").fit(Xp, yp, train=False)
    jfleet = JGPFleet(JFleetConfig()).fit(jnp.asarray(Xp), jnp.asarray(yp),
                                          train=False)
    _close(fleet.log_theta, jfleet.log_theta, 1e-15)
    _close(fleet.predict(Xs, method="poe")[0],
           jfleet.predict(jnp.asarray(Xs), method="poe")[0])


def test_fleet_float32_follows_the_inputs(data):
    Xp, yp, Xs = (a.astype(np.float32) for a in data)
    fleet = GPFleet(FleetConfig(stream_mean=True), device="cpu").fit(
        Xp, yp, train=False)
    mean, var, _ = fleet.predict(Xs)
    assert mean.dtype == torch.float32 and bool(torch.isfinite(var).all())


def test_fit_with_training_is_not_ported(data):
    """Every trainer is ported (tests/test_torch_training.py, the sparse
    trainers in tests/test_torch_sparse.py, gapx and dec-gapx in
    tests/test_torch_fleet_methods.py, the sharded loop in
    tests/test_torch_sharded.py). The training trace is ported
    (tests/test_torch_obs.py). The sharded loop runs one agent per mesh
    member, so on the CPU fleet's one-member default mesh it refuses a
    4-agent fleet, as the reference does, and trains on a 4-member mesh.
    The sparse trainers need sparse_m, as the reference's rule says, and
    train with it; the gapx trainers train on the augmented data."""
    Xp, yp, _ = data
    fleet = GPFleet(FleetConfig(trainer="dec-apx-sharded", admm_iters=2),
                    device="cpu")
    with pytest.raises(ValueError, match="ONE agent per mesh member"):
        fleet.fit(Xp, yp)
    fleet.fit(Xp, yp, train=False)                # serving known theta works
    fleet = GPFleet(FleetConfig(trainer="dec-apx-sharded", admm_iters=2),
                    mesh=make_agent_mesh(4, devices=("cpu",) * 4),
                    device="cpu").fit(Xp, yp, log_theta0=LOG_THETA)
    assert fleet.thetas.shape == (4, 4)
    assert bool(torch.isfinite(fleet.predict(data[2])[0]).all())
    for trainer in ("gapx", "dec-gapx"):
        fleet = GPFleet(FleetConfig(trainer=trainer, admm_iters=2),
                        device="cpu").fit(Xp, yp, log_theta0=LOG_THETA)
        assert fleet.thetas.shape == (4, 4)
        assert bool(torch.isfinite(fleet.predict(data[2])[0]).all())
    for trainer in ("fact-sparse", "dec-apx-sparse"):
        with pytest.raises(ValueError, match="needs the per-agent inducing"):
            GPFleet(FleetConfig(trainer=trainer), device="cpu")
        fleet = GPFleet(FleetConfig(trainer=trainer, sparse_m=8,
                                    admm_iters=2, fact_steps=2),
                        device="cpu").fit(Xp, yp, log_theta0=LOG_THETA)
        assert fleet.fitted.Z.shape == (4, 8, 2)
        assert bool(torch.isfinite(fleet.predict(data[2])[0]).all())
    rec = TraceRecorder()
    GPFleet(FleetConfig(admm_iters=2), device="cpu").fit(
        Xp, yp, log_theta0=LOG_THETA, trace=rec)
    assert rec.last()["name"] == "dec-apx" and rec.last()["nll"].shape == (2,
                                                                          4)


def test_fleet_shape_errors(data):
    Xp, yp, _ = data
    with pytest.raises(ValueError, match="num_agents"):
        GPFleet(FleetConfig(num_agents=5), device="cpu").fit(Xp, yp,
                                                             train=False)
    with pytest.raises(RuntimeError, match="fit"):
        GPFleet(FleetConfig(), device="cpu").predict(data[2])


@pytest.mark.parametrize("kw,err,match", [
    (dict(routed=True), ValueError, "routed serving runs on the sharded"),
    (dict(method="nn_grbcm", online=True), ValueError, "online-safe"),
    (dict(method="npae-sparse"), ValueError, "sparse_m"),
    (dict(method="nope"), KeyError, "unknown prediction method"),
    (dict(trainer="nope"), KeyError, "unknown trainer"),
    (dict(sharded=True, method="npae"), ValueError,
     "not servable on the agent-sharded"),
    (dict(sparse_m=8, online=True), ValueError, "mutually exclusive"),
    (dict(cache_cross=True, sparse_m=8), ValueError, "cache_cross"),
])
def test_validate_config_rejects_what_is_not_ported(kw, err, match):
    """What is unknown, and the reference's rules (routed serving needs
    the sharded fleet; the dense NPAE family does not shard; grbcm methods
    are not online-safe; npae_sparse without sparse_m; sparse_m with
    online or with the cross-Gram cache)."""
    with pytest.raises(err, match=match):
        validate_config(FleetConfig(**kw))
    with pytest.raises(err, match=match):
        GPFleet(FleetConfig(**kw), device="cpu")


def test_online_config_validates_and_fits_on_the_cpu(data):
    """Online experts are ported: the config validates, and fit builds the
    sliding windows (window 32 < Ni keeps each agent's newest points)."""
    Xp, yp, Xs = data
    cfg = FleetConfig(online=True, window=32)
    validate_config(cfg)
    fleet = GPFleet(cfg, device="cpu").fit(Xp, yp, log_theta0=LOG_THETA,
                                           train=False)
    assert fleet.window_counts.tolist() == [32] * 4
    assert fleet.fitted.L.shape == (4, 32, 32)
    _close(fleet.fitted.Xp, Xp[:, -32:], 0)
    assert GPFleet(FleetConfig(), device="cpu").fit(
        Xp, yp, train=False).window_counts is None
    with pytest.raises(RuntimeError, match="streaming fleet"):
        GPFleet(FleetConfig(), device="cpu").fit(
            Xp, yp, train=False).observe(Xs[:4], np.zeros(4))
    with pytest.raises(RuntimeError, match="fit"):
        GPFleet(cfg, device="cpu").observe(Xs[:4], np.zeros(4))


@pytest.mark.parametrize("method", ["rbcm", "gpoe"])
def test_online_fleet_observe_drift_join_leave_matches_reference(data,
                                                                 method):
    """The streaming lifecycle end to end against the JAX GPFleet on the
    same float64 arrays: observe rounds, a drift epoch of DEC-apx-GP on
    the live windows, a join, a leave, serving after each."""
    Xp, yp, Xs = data
    rng = np.random.default_rng(8)
    kw = dict(online=True, window=30, chunk=16, dac_iters=150,
              method=method, kappa=10_000.0)
    fleet = GPFleet(FleetConfig(**kw), device="cpu").fit(
        Xp, yp, log_theta0=LOG_THETA, train=False)
    jfleet = JGPFleet(JFleetConfig(**kw)).fit(
        jnp.asarray(Xp), jnp.asarray(yp),
        log_theta0=jnp.asarray(LOG_THETA), train=False)

    def same_predictions():
        for got, want in zip(fleet.predict(Xs)[:2],
                             jfleet.predict(jnp.asarray(Xs))[:2]):
            _close(got, want)
    same_predictions()
    engine = fleet.engine
    for _ in range(6):
        xs, ys = rng.uniform(0, 2, (4, 2)), rng.standard_normal(4)
        fleet.observe(xs, ys)
        jfleet.observe(jnp.asarray(xs), jnp.asarray(ys))
    assert fleet.engine is engine and engine.fitted.L is fleet.fitted.L
    same_predictions()
    info = fleet.drift(iters=3)
    jinfo = jfleet.drift(iters=3)
    _close(fleet.log_theta, jfleet.log_theta)
    _close(info["residuals"], jinfo["residuals"], 1e-6)
    same_predictions()
    Xn, yn = rng.uniform(0, 2, (20, 2)), rng.standard_normal(20)
    fleet.join(Xn, yn)
    jfleet.join(jnp.asarray(Xn), jnp.asarray(yn))
    assert fleet.num_agents == 5 and fleet.window_counts.tolist() == \
        [30, 30, 30, 30, 20]
    same_predictions()
    fleet.leave(1)
    jfleet.leave(1)
    _close(fleet.A, jfleet.A, 0)
    assert fleet.engine is engine and fleet.config.num_agents == 4
    same_predictions()


def test_registry_serves_the_dac_family():
    """The paper's 13 methods, and npae_sparse for sparse fleets."""
    assert sorted(METHODS) == sorted(
        ["poe", "gpoe", "bcm", "rbcm", "grbcm", "npae", "npae_star",
         "nn_poe", "nn_gpoe", "nn_bcm", "nn_rbcm", "nn_grbcm", "nn_npae",
         "npae_sparse"])
    assert get_method("rbcm").paper == "Alg. 8, eq. 14-15"
    assert get_method("npae-sparse").family == "sparse"
    assert get_method("nn-npae").family == "npae"


def test_serve_gp_runs_on_the_cpu(capsys):
    serve_gp.main(["--device", "cpu", "--agents", "4", "--per-agent", "32",
                   "--requests", "5", "--batch", "32", "--chunk", "16"])
    out = capsys.readouterr().out
    assert "fleet: M=4 agents x Ni=32" in out
    assert "rbcm: served" in out and "stream_mean=True" in out


def test_serve_gp_rejects_training(capsys):
    """The launcher trains a positive number of rounds
    (test_serve_gp_trains_on_the_cpu trains), and dec-apx-sharded on its
    mesh: the CPU launcher's one-member mesh refuses the 8-agent fleet,
    as the reference's one-device mesh does."""
    with pytest.raises(SystemExit):
        serve_gp.main(["--device", "cpu", "--train-iters", "-1"])
    with pytest.raises(ValueError, match="ONE agent per mesh member"):
        serve_gp.main(["--device", "cpu", "--trainer", "dec-apx-sharded",
                       "--train-iters", "5"])


def test_serve_gp_trains_on_the_cpu(capsys):
    serve_gp.main(["--device", "cpu", "--trainer", "dec-apx",
                   "--train-iters", "5", "--agents", "4", "--per-agent",
                   "32", "--requests", "3", "--batch", "32", "--chunk", "16"])
    out = capsys.readouterr().out
    assert "trained (dec-apx, 5 rounds)" in out and "trained theta" in out
    assert "rbcm: served" in out


def test_serve_gp_online_on_the_cpu(capsys):
    serve_gp.main(["--device", "cpu", "--online", "--observe-every", "2",
                   "--agents", "4", "--per-agent", "32", "--requests", "5",
                   "--batch", "32", "--chunk", "16"])
    out = capsys.readouterr().out
    assert "online rbcm: served" in out and "obs/s" in out
    assert "factors swapped in place" in out
    with pytest.raises(SystemExit):
        serve_gp.main(["--device", "cpu", "--online", "--method",
                       "cen_rbcm"])


def test_micro_batches_pad_and_slice():
    reqs = [torch.ones(3, 2), 2 * torch.ones(6, 2)]
    batches, total, slices = serve_gp.micro_batches(reqs, 4)
    assert batches.shape == (3, 4, 2) and total == 9
    assert slices == [(0, 3), (3, 9)]
    assert float(batches.reshape(-1, 2)[9:].abs().sum()) == 0.0
