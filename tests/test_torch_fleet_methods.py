"""The grBCM communication dataset, the augmented-data trainers and the
fleet rules that come with CBNN, grBCM and dense NPAE, against the JAX
package on the CPU in float64.

The port draws D_c with a torch.Generator, which cannot reproduce
`jax.random.choice`, so its sampler is tested statistically, and every
parity test hands the reference's own draw (Xc, yc) to the port
(`GPFleet.fit(comm_data=...)`). Predictions to 1e-9 relative (as
tests/test_torch_fleet.py); gapx / dec-gapx trajectories to 1e-6 (as the
DEC-apx-GP trajectory in tests/test_torch_training.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gp import augment as jaugment
from repro.core.training import train_dec_gapx_gp as j_train_dec_gapx_gp
from repro.core.training import train_gapx_gp as j_train_gapx_gp
from repro.fleet import FleetConfig as JFleetConfig
from repro.fleet import GPFleet as JGPFleet
from repro.fleet import TRAINERS as J_TRAINERS
from repro.fleet import METHODS as J_METHODS
from repro_torch.core.consensus import path_graph
from repro_torch.core.gp import augment, communication_dataset
from repro_torch.core.sparse import SparseExperts
from repro_torch.core.training import train_dec_gapx_gp, train_gapx_gp
from repro_torch.fleet import (METHODS, TRAINERS, FleetConfig, GPFleet,
                               get_method, get_trainer, validate_config)

torch.set_num_threads(2)

TOL = 1e-9
LOG_THETA = np.log([1.2, 0.3, 1.3, 0.1])
M, NI = 4, 40
SMALL = dict(chunk=16, dac_iters=120, jor_iters=150, dale_iters=300,
             pm_iters=40, eta_nn=0.5)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    X = rng.uniform(0, 2, (M * NI, 2))
    X = X[np.argsort(X[:, 0])]
    y = np.cos(2 * X[:, 0] + X[:, 1]) + 0.1 * rng.normal(size=len(X))
    return X.reshape(M, NI, 2), y.reshape(M, NI), rng.uniform(0, 2, (29, 2))


def _jfleet(data, **kw):
    Xp, yp, _ = data
    return JGPFleet(JFleetConfig(**kw)).fit(
        jnp.asarray(Xp), jnp.asarray(yp), key=jax.random.PRNGKey(5),
        log_theta0=jnp.asarray(LOG_THETA), train=False)


# -------------------------------------------------- communication dataset

def test_communication_dataset_draws_m_distinct_points_per_stripe():
    """N_i / M points per agent, none repeated, each from its own agent's
    stripe, agent 0's first; reproducible from a generator."""
    M_, Ni = 5, 23
    X = torch.arange(M_ * Ni * 2, dtype=torch.float64).reshape(M_, Ni, 2)
    y = X[..., 0] / 2
    g = torch.Generator().manual_seed(11)
    Xc, yc = communication_dataset(g, X, y)
    m = Ni // M_
    assert Xc.shape == (M_ * m, 2) and yc.shape == (M_ * m,)
    for i in range(M_):
        part = Xc[i * m:(i + 1) * m]
        rows = ((part[:, None, :] == X[i][None]).all(-1)).nonzero()[:, 1]
        assert rows.numel() == m and rows.unique().numel() == m
        torch.testing.assert_close(yc[i * m:(i + 1) * m], y[i, rows],
                                   rtol=0, atol=0)
    Xc2, yc2 = communication_dataset(torch.Generator().manual_seed(11), X, y)
    assert torch.equal(Xc, Xc2) and torch.equal(yc, yc2)
    Xc3, _ = communication_dataset(torch.Generator().manual_seed(12), X, y)
    assert not torch.equal(Xc, Xc3)
    # fewer points than agents: one point each, as the reference's max(., 1)
    Xs, _ = communication_dataset(g, X[:, :3], y[:, :3])
    assert Xs.shape == (M_, 2)


def test_communication_dataset_is_uniform_without_replacement():
    """Over 4,000 draws every point of a stripe is picked with frequency
    m / N_i (binomial, 5 sigma) and every pair of points equally often
    (no point's inclusion depends on another's position)."""
    M_, Ni, draws = 2, 12, 4000
    X = torch.arange(M_ * Ni, dtype=torch.float64).reshape(M_, Ni, 1)
    g = torch.Generator().manual_seed(0)
    m = Ni // M_
    counts = torch.zeros(M_, Ni)
    first_two = torch.zeros(Ni)
    for _ in range(draws):
        Xc, _ = communication_dataset(g, X, X[..., 0])
        idx = (Xc[:, 0] - torch.arange(M_).repeat_interleave(m) * Ni).long()
        counts.view(-1).index_add_(
            0, idx + torch.arange(M_).repeat_interleave(m) * Ni,
            torch.ones(M_ * m))
        first_two[idx[:m]] += 1
    p = m / Ni
    sd = (draws * p * (1 - p)) ** 0.5
    assert float((counts - draws * p).abs().max()) <= 5 * sd
    assert float((first_two - draws * p).abs().max()) <= 5 * sd


def test_communication_dataset_follows_the_generator_device():
    X = torch.rand(3, 9, 2, dtype=torch.float64)
    Xc, yc = communication_dataset(None, X, X[..., 0])
    assert Xc.shape == (9, 2) and Xc.device == X.device


def test_augment_matches_reference(data):
    Xp, yp, _ = data
    rng = np.random.default_rng(1)
    Xc, yc = rng.uniform(size=(M * 10, 2)), rng.normal(size=M * 10)
    got = augment(torch.tensor(Xp), torch.tensor(yp), torch.tensor(Xc),
                  torch.tensor(yc))
    want = jaugment(jnp.asarray(Xp), jnp.asarray(yp), jnp.asarray(Xc),
                    jnp.asarray(yc))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (M, NI + M * 10, 2)


# ---------------------------------------------------------------- registry

def test_registry_flags_match_reference():
    assert set(METHODS) == set(J_METHODS)
    for name, spec in METHODS.items():
        ref = J_METHODS[name]
        assert (spec.family, spec.online_safe, spec.needs_augmented_data,
                spec.sparse) == (ref.family, ref.online_safe,
                                 ref.needs_augmented_data, ref.sparse), name
    assert set(TRAINERS) == set(J_TRAINERS)
    for name, spec in TRAINERS.items():
        assert (spec.needs_augmented_data, spec.needs_mesh) == \
            (J_TRAINERS[name].needs_augmented_data,
             J_TRAINERS[name].needs_mesh), name
    assert get_trainer("dec-apx-sharded").needs_mesh
    for name, spec in METHODS.items():
        assert (spec.shardable, spec.routable) == \
            (J_METHODS[name].shardable, J_METHODS[name].routable), name
    assert get_method("nn-grbcm").needs_augmented_data


@pytest.mark.parametrize("kw", [
    dict(method="grbcm", online=True), dict(method="nn_grbcm", online=True),
    dict(method="npae", sparse_m=8), dict(method="nn_npae", sparse_m=8),
    dict(method="npae_star", sparse_m=8),
    dict(method="rbcm", sparse_m=8, cache_cross=True)])
def test_validate_config_rejects_like_reference(kw):
    from repro.fleet import validate_config as jvalidate
    with pytest.raises(ValueError):
        jvalidate(JFleetConfig(**kw))
    with pytest.raises(ValueError):
        validate_config(FleetConfig(**kw))
    with pytest.raises(ValueError):
        GPFleet(FleetConfig(**kw), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(method="grbcm", sparse_m=8), dict(method="nn_rbcm", sparse_m=8),
    dict(method="npae", cache_cross=True), dict(trainer="gapx"),
    dict(trainer="dec-gapx", method="nn_grbcm"), dict(method="nn_npae")])
def test_validate_config_accepts_like_reference(kw):
    from repro.fleet import validate_config as jvalidate
    jvalidate(JFleetConfig(**kw))
    validate_config(FleetConfig(**kw))


# ------------------------------------------------------------ fleet rules

@pytest.mark.parametrize("trainer,method,train,built", [
    ("dec-apx", "rbcm", False, False), ("dec-apx", "grbcm", False, True),
    ("dec-gapx", "rbcm", False, False), ("gapx", "rbcm", True, True),
    ("dec-apx", "nn_grbcm", False, True)])
def test_fit_builds_comm_data_only_when_consumed(data, trainer, method,
                                                 train, built):
    Xp, yp, _ = data
    cfg = FleetConfig(trainer=trainer, method=method, admm_iters=2)
    fleet = GPFleet(cfg, device="cpu").fit(
        Xp, yp, generator=torch.Generator().manual_seed(0),
        log_theta0=LOG_THETA, train=train)
    assert (fleet._comm_data is not None) == built
    aug = get_method(method).needs_augmented_data
    assert (fleet.fitted_aug is not None) == aug
    assert (fleet.fitted_comm is not None) == aug
    if aug:
        assert fleet.fitted_aug.Xp.shape == (M, NI + NI, 2)
        assert fleet.fitted_comm.Xp.shape == (1, NI, 2)


@pytest.mark.parametrize("method", ["grbcm", "nn_grbcm", "cen_grbcm"])
def test_fleet_grbcm_serves_like_reference_on_its_draw(data, method):
    """The reference's communication dataset handed to the port: the
    augmented and communication experts, and the served moments."""
    base = method[4:] if method.startswith("cen_") else method
    jfleet = _jfleet(data, method=base, **SMALL)
    Xc, yc = (np.asarray(a) for a in jfleet._comm_data[:2])
    Xp, yp, Xs = data
    fleet = GPFleet(FleetConfig(method=base, **SMALL), device="cpu").fit(
        Xp, yp, comm_data=(Xc, yc), log_theta0=LOG_THETA, train=False)
    _close(fleet.fitted_aug.L, jfleet.fitted_aug.L)
    _close(fleet.fitted_comm.alpha, jfleet.fitted_comm.alpha)
    mean, var, _ = fleet.predict(Xs, method=method)
    meanj, varj, _ = jfleet.predict(jnp.asarray(Xs), method=method)
    _close(mean, meanj)
    _close(var, varj)


def test_sparse_fleet_fits_sparse_augmented_experts(data):
    Xp, yp, Xs = data
    kw = dict(method="grbcm", sparse_m=8, **SMALL)
    jfleet = _jfleet(data, **kw)
    Xc, yc = (np.asarray(a) for a in jfleet._comm_data[:2])
    fleet = GPFleet(FleetConfig(**kw), device="cpu").fit(
        Xp, yp, comm_data=(Xc, yc), log_theta0=LOG_THETA, train=False)
    assert isinstance(fleet.fitted_aug, SparseExperts)
    assert isinstance(fleet.fitted_comm, SparseExperts)
    assert fleet.fitted_comm.Z.shape == (1, 8, 2)
    mean, _, _ = fleet.predict(Xs)
    meanj, _, _ = jfleet.predict(jnp.asarray(Xs))
    _close(mean, meanj, 1e-7)


def test_fleet_caches_the_cross_gram_when_configured(data):
    Xp, yp, Xs = data
    kw = dict(method="npae", cache_cross=True, **SMALL)
    fleet = GPFleet(FleetConfig(**kw), device="cpu").fit(
        Xp, yp, log_theta0=LOG_THETA, train=False)
    assert fleet.fitted.Kcross.shape == (M, M, NI, NI)
    jfleet = _jfleet(data, **kw)
    for got, want in zip(fleet.predict(Xs)[:2],
                         jfleet.predict(jnp.asarray(Xs))[:2]):
        _close(got, want)
    plain = GPFleet(FleetConfig(method="npae", **SMALL), device="cpu").fit(
        Xp, yp, log_theta0=LOG_THETA, train=False)
    assert plain.fitted.Kcross is None
    _close(fleet.predict(Xs)[0], plain.predict(Xs)[0])


@pytest.mark.parametrize("method", ["grbcm", "nn_grbcm", "cen_grbcm"])
def test_predict_rejects_grbcm_without_augmented_experts(data, method):
    Xp, yp, Xs = data
    fleet = GPFleet(FleetConfig(), device="cpu").fit(
        Xp, yp, log_theta0=LOG_THETA, train=False)
    jfleet = _jfleet(data)
    with pytest.raises(ValueError, match="augmented"):
        fleet.predict(Xs, method=method)
    with pytest.raises(ValueError, match="augmented"):
        jfleet.predict(jnp.asarray(Xs), method=method)


def test_online_fleets_reject_grbcm_and_drift_rejects_gapx(data):
    Xp, yp, Xs = data
    with pytest.raises(ValueError, match="online-safe"):
        GPFleet(FleetConfig(online=True, method="grbcm"), device="cpu")
    online = GPFleet(FleetConfig(online=True, window=20), device="cpu").fit(
        Xp, yp, log_theta0=LOG_THETA, train=False)
    with pytest.raises(ValueError, match="augmented"):
        online.predict(Xs, method="nn_grbcm")
    for trainer in ("gapx", "dec-gapx"):
        fleet = GPFleet(FleetConfig(online=True, window=20, trainer=trainer),
                        device="cpu").fit(Xp, yp, log_theta0=LOG_THETA,
                                          train=False)
        jfleet = JGPFleet(JFleetConfig(online=True, window=20,
                                       trainer=trainer)).fit(
            jnp.asarray(Xp), jnp.asarray(yp),
            log_theta0=jnp.asarray(LOG_THETA), train=False)
        with pytest.raises(ValueError, match="sliding windows"):
            fleet.drift(iters=2)
        with pytest.raises(ValueError, match="sliding windows"):
            jfleet.drift(iters=2)


@pytest.mark.parametrize("method", ["nn_poe", "nn_npae", "npae_star"])
def test_fleet_serves_cbnn_and_npae_like_reference(data, method):
    Xp, yp, Xs = data
    fleet = GPFleet(FleetConfig(method=method, **SMALL), device="cpu").fit(
        Xp, yp, log_theta0=LOG_THETA, train=False)
    jfleet = _jfleet(data, method=method, **SMALL)
    mean, var, info = fleet.predict(Xs)
    meanj, varj, infoj = jfleet.predict(jnp.asarray(Xs))
    _close(mean, meanj)
    _close(var, varj)
    if "mask" in infoj:
        np.testing.assert_array_equal(info["mask"].numpy(),
                                      np.asarray(infoj["mask"]))


# --------------------------------------------------------------- training

@pytest.mark.parametrize("trainer", ["gapx", "dec-gapx"])
def test_gapx_trainers_match_reference_on_its_draw(data, trainer):
    """GPFleet.fit(train=True) trains on D_{+i} built from the reference's
    (Xc, yc): the theta trajectory and the served moments."""
    Xp, yp, Xs = data
    kw = dict(trainer=trainer, method="grbcm", admm_iters=10,
              kappa=10_000.0, lipschitz=10_000.0, **SMALL)
    jfleet = JGPFleet(JFleetConfig(**kw)).fit(
        jnp.asarray(Xp), jnp.asarray(yp), key=jax.random.PRNGKey(2),
        log_theta0=jnp.asarray(LOG_THETA))
    Xc, yc = (np.asarray(a) for a in jfleet._comm_data[:2])
    fleet = GPFleet(FleetConfig(**kw), device="cpu").fit(
        Xp, yp, comm_data=(Xc, yc), log_theta0=LOG_THETA)
    _close(fleet.log_theta, jfleet.log_theta, 1e-6)
    _close(fleet.thetas, jfleet.thetas, 1e-6)
    _close(fleet.train_info["residuals"], jfleet.train_info["residuals"],
           1e-6)
    for got, want in zip(fleet.predict(Xs)[:2],
                         jfleet.predict(jnp.asarray(Xs))[:2]):
        _close(got, want, 1e-6)


def test_gapx_loops_match_reference(data):
    Xp, yp, _ = data
    rng = np.random.default_rng(4)
    Xc = rng.uniform(0, 2, (NI, 2))
    yc = np.cos(2 * Xc[:, 0] + Xc[:, 1])
    Xa, ya = (np.asarray(a) for a in jaugment(
        jnp.asarray(Xp), jnp.asarray(yp), jnp.asarray(Xc), jnp.asarray(yc)))
    z, thetas, info = train_gapx_gp(torch.tensor(LOG_THETA),
                                    torch.tensor(Xa), torch.tensor(ya),
                                    iters=8)
    zj, thetasj, infoj = j_train_gapx_gp(jnp.asarray(LOG_THETA),
                                         jnp.asarray(Xa), jnp.asarray(ya),
                                         iters=8)
    _close(z, zj, 1e-6)
    _close(thetas, thetasj, 1e-6)
    _close(info["residuals"], infoj["residuals"], 1e-6)
    A = path_graph(M)
    th, info = train_dec_gapx_gp(torch.tensor(LOG_THETA), torch.tensor(Xa),
                                 torch.tensor(ya), A, kappa=10_000.0,
                                 iters=8)
    thj, infoj = j_train_dec_gapx_gp(jnp.asarray(LOG_THETA),
                                     jnp.asarray(Xa), jnp.asarray(ya),
                                     jnp.asarray(A.numpy()), kappa=10_000.0,
                                     iters=8)
    _close(th, thj, 1e-6)
    _close(info["residuals"], infoj["residuals"], 1e-6)
