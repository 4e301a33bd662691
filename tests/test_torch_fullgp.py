"""The FULL-GP baseline and the rest of ROADMAP A12 in the port against the
JAX package, on the CPU in float64 (conftest turns x64 on):

* `predict_full`, `nll_value_and_grad` and `dac_time_varying` to 1e-9
  relative (same algorithms, different LAPACK/BLAS rounding);
* `sst_like_field`'s f to 1e-12, its noise held to N(0, 0.25)
  statistically (the port's draws come from a torch.Generator, not
  `jax.random`);
* `sgd` with and without momentum (and a callable lr) to 1e-12;
* `train_full_gp`: the reference's `_fit_one` against the port's from the
  same starts (the reference's own multi-start draws, made here with
  `jax.random` and fed to both) to 1e-9 relative on log theta and on the
  NLL history (tighter than the DEC-apx-GP trajectory's 1e-6: 200 Adam
  steps at N = 40 agree to about 6e-14), and `num_starts=1` end to end;
* DAC on the paper's largest fleet, M = 40 on a path graph, at tiny Ni:
  both packages stop at the same unconverged residual after 200 sweeps;
* `configs.paper_gp` equals the reference's, and FleetConfig's defaults
  equal it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_gp as jpaper
from repro.core.consensus import path_graph as jpath
from repro.core.consensus.dac import dac as j_dac
from repro.core.consensus.dac import dac_time_varying as j_dac_tv
from repro.core.gp import exact as jexact
from repro.core.gp import nll_value_and_grad as j_nll_vg
from repro.data.synthetic import sst_like_field as j_sst
from repro.fleet import FleetConfig as JFleetConfig
from repro.fleet import GPFleet as JGPFleet
from repro.optim.adam import apply_updates as j_apply
from repro.optim.adam import sgd as j_sgd
from repro_torch.configs import paper_gp
from repro_torch.core.consensus import dac, dac_time_varying, path_graph
from repro_torch.core.gp import exact, nll_value_and_grad, predict_full
from repro_torch.data import sst_like_field
from repro_torch.fleet import FleetConfig, GPFleet
from repro_torch.optim import apply_updates, sgd

torch.set_num_threads(2)

TOL = 1e-9
LOG_THETA = np.log([1.2, 0.3, 1.3, 0.1])


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def _data(n, seed, nq=17):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n, 2))
    y = np.sin(5 * X[:, 0]) * np.cos(3 * X[:, 1]) + 0.1 * rng.normal(size=n)
    return X, y, rng.uniform(0, 1, (nq, 2))


def test_paper_config_matches_reference_and_fleet_defaults():
    ours = dataclasses.asdict(paper_gp.CONFIG)
    assert ours == dataclasses.asdict(jpaper.CONFIG)
    cfg = FleetConfig()
    for f in ("theta0", "graph", "rho", "kappa", "lipschitz", "admm_iters",
              "nested_lr", "eta_nn"):
        assert getattr(cfg, f) == ours[f], f
    assert cfg.num_agents == ours["fleets"][0]


@pytest.mark.parametrize("n", [30, 90])
def test_predict_full_matches_reference(n):
    X, y, Xs = _data(n, n)
    mean, var = predict_full(torch.tensor(LOG_THETA), torch.tensor(X),
                             torch.tensor(y), torch.tensor(Xs))
    jmean, jvar = jexact.predict_full(jnp.asarray(LOG_THETA), jnp.asarray(X),
                                      jnp.asarray(y), jnp.asarray(Xs))
    assert mean.dtype == torch.float64
    _close(mean, jmean)
    _close(var, jvar)


@pytest.mark.parametrize("theta", [[1.2, 0.3, 1.3, 0.1], [0.4, 0.9, 0.7, 0.5]])
def test_nll_value_and_grad_matches_reference(theta):
    X, y, _ = _data(50, 7)
    lt = np.log(theta)
    val, g = nll_value_and_grad(torch.tensor(lt), torch.tensor(X),
                                torch.tensor(y))
    jval, jg = j_nll_vg(jnp.asarray(lt), jnp.asarray(X), jnp.asarray(y))
    _close(val, jval)
    _close(g, jg)


@pytest.mark.parametrize("K", [None, 3])
def test_dac_time_varying_matches_reference(K):
    rng = np.random.default_rng(5)
    T, M = 30, 6
    A_seq = (rng.uniform(size=(T, M, M)) < 0.4).astype(np.float64)
    A_seq = np.triu(A_seq, 1)
    A_seq = A_seq + np.swapaxes(A_seq, 1, 2)
    w0 = rng.normal(size=(M,) if K is None else (M, K))
    w, res = dac_time_varying(torch.tensor(w0), torch.tensor(A_seq), 0.2)
    jw, jres = j_dac_tv(jnp.asarray(w0), jnp.asarray(A_seq), 0.2)
    _close(w, jw)
    _close(res, jres)
    assert res.shape == (T,)


def test_sst_like_field_f_matches_reference():
    X, _, _ = _data(500, 2)
    f, _ = sst_like_field(torch.tensor(X))
    jf, _ = j_sst(jnp.asarray(X))
    _close(f, jf, 1e-12)


def test_sst_like_field_noise_is_iid_normal():
    """y - f ~ N(0, noise_std^2) iid: mean, variance and lag-1
    correlation within 5 standard errors at n = 40,000; the default draw
    is the one of a generator seeded 0, and a generator's seed decides
    it."""
    n = 40_000
    X = torch.rand(n, 2, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(9))
    f, y = sst_like_field(X, noise_std=0.5,
                          generator=torch.Generator().manual_seed(4))
    e = (y - f).numpy()
    se = 0.5 / np.sqrt(n)
    assert abs(e.mean()) < 5 * se
    assert abs(e.var() - 0.25) < 5 * 0.25 * np.sqrt(2.0 / n)
    assert abs(np.corrcoef(e[:-1], e[1:])[0, 1]) < 5 / np.sqrt(n)
    _, y0 = sst_like_field(X)
    _, y0b = sst_like_field(X, generator=torch.Generator().manual_seed(0))
    assert torch.equal(y0, y0b) and not torch.equal(y0, y)


@pytest.mark.parametrize("momentum,callable_lr",
                         [(0.0, False), (0.9, False), (0.5, True)])
def test_sgd_matches_reference(momentum, callable_lr):
    rng = np.random.default_rng(int(momentum * 10))
    params = {"a": rng.normal(size=(3, 2)), "b": rng.normal(size=4)}
    grads = [{k: rng.normal(size=v.shape) for k, v in params.items()}
             for _ in range(5)]
    lr = (lambda s: 0.1 / (1.0 + s)) if callable_lr else 0.05
    opt, jopt = sgd(lr, momentum), j_sgd(lr, momentum)
    p = {k: torch.tensor(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st, jst = opt.init(p), jopt.init(jp)
    for g in grads:
        upd, st = opt.update({k: torch.tensor(v) for k, v in g.items()}, st)
        p = apply_updates(p, upd)
        jupd, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                jst)
        jp = j_apply(jp, jupd)
    for k in params:
        _close(p[k], jp[k], 1e-12)
    assert int(st["step"]) == int(jst["step"]) == 5


def _reference_starts(key, D, num_starts):
    """The starts the reference's train_full_gp draws from `key`."""
    lt0 = jnp.zeros(D + 2, jnp.float64)
    return [lt0] + [lt0 + 0.5 * jax.random.normal(k, (D + 2,), jnp.float64)
                    for k in jax.random.split(key, num_starts - 1)]


def test_fit_one_matches_reference_from_the_same_starts():
    X, y, _ = _data(40, 3)
    for s in _reference_starts(jax.random.PRNGKey(0), 2, 3):
        jlt, jval, jhist = jexact._fit_one(s, jnp.asarray(X), jnp.asarray(y),
                                           steps=200, lr=0.05)
        lt, val, hist = exact._fit_one(torch.tensor(np.asarray(s)),
                                       torch.tensor(X), torch.tensor(y),
                                       steps=200, lr=0.05)
        _close(lt, jlt)
        _close(val, jval)
        _close(hist, jhist)


def test_train_full_gp_one_start_end_to_end():
    X, y, Xs = _data(40, 8)
    lt, info = exact.train_full_gp(torch.tensor(X), torch.tensor(y),
                                   num_starts=1, steps=100)
    jlt, jinfo = jexact.train_full_gp(jnp.asarray(X), jnp.asarray(y),
                                      jax.random.PRNGKey(0), num_starts=1,
                                      steps=100)
    _close(lt, jlt)
    _close(info["nll"], jinfo["nll"])
    _close(info["history"], jinfo["history"])
    assert info["history"].shape == (100,)
    # the multi-start path: a generator's starts, the best NLL is kept
    lt3, info3 = exact.train_full_gp(
        torch.tensor(X), torch.tensor(y),
        generator=torch.Generator().manual_seed(1), num_starts=3, steps=100)
    assert float(info3["nll"]) <= float(info["nll"]) + 1e-12
    assert torch.isfinite(lt3).all()


def test_dac_on_the_40_agent_path_stops_unconverged_like_reference():
    """The paper's M = 40 fleet on a path graph: 200 sweeps at
    eps = 1/3 leave about 0.66 of the slowest mode, in both packages."""
    M, Ni = 40, 5
    rng = np.random.default_rng(40)
    X = np.sort(rng.uniform(0, 2, (M * Ni, 2)), axis=0)
    y = np.sin(2 * X[:, 0]) + 0.1 * rng.normal(size=M * Ni)
    Xp, yp = X.reshape(M, Ni, 2), y.reshape(M, Ni)
    Xs = rng.uniform(0, 2, (16, 2))
    kw = dict(num_agents=M, chunk=16, dac_iters=200)
    mean, var, info = GPFleet(FleetConfig(**kw), device="cpu").fit(
        Xp, yp, log_theta0=LOG_THETA, train=False).predict(Xs)
    jmean, jvar, jinfo = JGPFleet(JFleetConfig(**kw)).fit(
        jnp.asarray(Xp), jnp.asarray(yp), log_theta0=jnp.asarray(LOG_THETA),
        train=False).predict(jnp.asarray(Xs))
    _close(mean, jmean)
    _close(var, jvar)
    _close(info["dac_residual"], jinfo["dac_residual"])
    w0 = rng.normal(size=M)
    _, res = dac(torch.tensor(w0), path_graph(M), 200)
    _, jres = j_dac(jnp.asarray(w0), jpath(M), 200)
    _close(res, jres)
    assert float(res[-1]) > 0.1 * float(res[0])      # far from consensus
