"""Parity of the port's prediction layer (repro_torch.core.prediction) with
the JAX package: factors, local moments, the DAC-family cores and the
query-tiled PredictionEngine, on the same float64 numpy inputs.

Tolerance 1e-9 relative to max|reference| throughout: both packages run
the same float64 algorithms (Cholesky, triangular solves, 150 DAC sweeps)
through different LAPACK/BLAS builds, whose rounding differences grow
with the conditioning of C_i = K_i + sigma_eps^2 I (cond ~1e3 here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.consensus import path_graph as jpath_graph
from repro.core.prediction import PredictionEngine as JEngine
from repro.core.prediction import aggregation as jagg
from repro.core.prediction import decentralized as jdec
from repro.core.prediction import dec_rbcm as jdec_rbcm
from repro.core.prediction import fit_experts as jfit_experts
from repro.core.prediction import local_moments_cached as jlocal_cached
from repro.core.prediction import map_query_tiles as jmap_query_tiles
from repro_torch.core.consensus import path_graph
from repro_torch.core.prediction import (FittedExperts, PredictionEngine,
                                         dec_rbcm, fit_experts,
                                         local_moments_cached,
                                         map_query_tiles)
from repro_torch.core.prediction import aggregation as tagg
from repro_torch.core.prediction import decentralized as tdec

torch.set_num_threads(2)

TOL = 1e-9
M, NI, NT, CHUNK, ITERS = 4, 48, 37, 16, 150     # NT ragged over CHUNK
LOG_THETA = np.log([1.2, 0.3, 1.3, 0.1])


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.fixture(scope="module")
def data():
    """Stripes of a smooth noisy field over [0, 2]^2, and ragged queries."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 2, (M * NI, 2))
    X = X[np.argsort(X[:, 0])]
    y = np.sin(2 * X[:, 0]) * np.cos(3 * X[:, 1]) \
        + 0.1 * rng.normal(size=M * NI)
    Xs = rng.uniform(0, 2, (NT, 2))
    return X.reshape(M, NI, 2), y.reshape(M, NI), Xs


@pytest.fixture(scope="module")
def fits(data):
    Xp, yp, _ = data
    jf = jfit_experts(jnp.asarray(LOG_THETA), jnp.asarray(Xp),
                      jnp.asarray(yp))
    tf = fit_experts(_t(LOG_THETA), _t(Xp), _t(yp))
    return jf, tf


@pytest.fixture(scope="module")
def jengines(fits):
    jf, _ = fits
    return {s: JEngine(jf, jpath_graph(M), chunk=CHUNK, dac_iters=ITERS,
                       stream_mean=s) for s in (False, True)}


def test_fit_experts_matches_reference(fits):
    jf, tf = fits
    _close(tf.L, jf.L)
    _close(tf.alpha, jf.alpha)
    assert tf.num_agents == M
    _close(tf.prior_var, jf.prior_var)


@pytest.mark.parametrize("stream_mean", [False, True])
def test_local_moments_cached_matches_reference(fits, data, stream_mean):
    jf, tf = fits
    Xs = data[2]
    mu, var = local_moments_cached(tf.log_theta, tf.Xp, tf.L, tf.alpha,
                                   _t(Xs), stream_mean=stream_mean)
    jmu, jvar = jlocal_cached(jf.log_theta, jf.Xp, jf.L, jf.alpha,
                              jnp.asarray(Xs), stream_mean=stream_mean)
    _close(mu, jmu)
    _close(var, jvar)


@pytest.mark.parametrize("method", ["poe", "gpoe", "bcm", "rbcm", "cen_poe",
                                    "cen_gpoe", "cen_bcm", "cen_rbcm"])
@pytest.mark.parametrize("stream_mean", [False, True])
def test_engine_matches_reference(fits, jengines, data, method, stream_mean):
    _, tf = fits
    Xs = data[2]
    eng = PredictionEngine(tf, path_graph(M), chunk=CHUNK, dac_iters=ITERS,
                           stream_mean=stream_mean, device="cpu")
    mean, var, info = eng.predict(method, Xs)
    jmean, jvar, jinfo = jengines[stream_mean].predict(method,
                                                       jnp.asarray(Xs))
    assert mean.shape == (NT,)
    _close(mean, jmean)
    _close(var, jvar)
    assert set(info) == set(jinfo)
    for k in info:
        # the final maximin spread is a difference of near-equal numbers
        # (consensus reached): compare it at the means' scale
        assert abs(float(info[k]) - float(jinfo[k])) <= \
            TOL * np.abs(np.asarray(jmean)).max()


def test_posterior_means_streamed_matches_reference(fits, jengines, data):
    _, tf = fits
    eng = PredictionEngine(tf, path_graph(M), device="cpu")
    _close(eng.posterior_means_streamed(data[2]),
           jengines[True].posterior_means_streamed(jnp.asarray(data[2])))


@pytest.mark.parametrize("name", ["poe", "gpoe", "bcm", "rbcm"])
@pytest.mark.parametrize("mask_kind", ["agents", "per_query"])
def test_masked_aggregation_matches_reference(name, mask_kind):
    """Agent masks, (M,) or (M, Nt), on the centralized closed forms and
    on the DAC cores."""
    rng = np.random.default_rng(5)
    mu = rng.normal(size=(M, NT))
    var = rng.uniform(0.05, 1.5, size=(M, NT))
    mask = (rng.random(M if mask_kind == "agents" else (M, NT)) < 0.7)
    mask[0] = True                      # every query keeps an agent
    pv = 1.69
    args = (pv,) if name in ("bcm", "rbcm") else ()
    got = getattr(tagg, name)(_t(mu), _t(var), *(_t(pv),) * len(args),
                              mask=_t(mask))
    want = getattr(jagg, name)(jnp.asarray(mu), jnp.asarray(var), *args,
                               mask=jnp.asarray(mask))
    for g, w in zip(got, want):
        _close(g, w)
    if mask_kind == "per_query":        # the DAC cores broadcast (M, Nt)
        core = f"dec_{name}_from_moments"
        got = getattr(tdec, core)(_t(mu), _t(var), _t(pv), path_graph(M),
                                  iters=ITERS, mask=_t(mask))
        want = getattr(jdec, core)(jnp.asarray(mu), jnp.asarray(var), pv,
                                   jpath_graph(M), iters=ITERS,
                                   mask=jnp.asarray(mask))
        _close(got[0], want[0])
        _close(got[1], want[1])


def test_per_call_dec_rbcm_matches_reference(data):
    Xp, yp, Xs = data
    mean, var, info = dec_rbcm(_t(LOG_THETA), _t(Xp), _t(yp), _t(Xs),
                               path_graph(M), iters=ITERS)
    jmean, jvar, jinfo = jdec_rbcm(jnp.asarray(LOG_THETA), jnp.asarray(Xp),
                                   jnp.asarray(yp), jnp.asarray(Xs),
                                   jpath_graph(M), iters=ITERS)
    _close(mean, jmean)
    _close(var, jvar)
    assert info["dac_residuals"].shape == (ITERS,)


def test_from_numpy_serves_a_jax_fit(fits, jengines, data):
    """The JAX fleet's fitted state, carried across as numpy, serves the
    same rbcm predictions from the port."""
    jf, _ = fits
    arrays = {k: np.asarray(getattr(jf, k)) for k in FittedExperts._fields}
    f = FittedExperts.from_numpy(arrays, device="cpu")
    assert f.L.dtype == torch.float64
    eng = PredictionEngine(f, path_graph(M), chunk=CHUNK, dac_iters=ITERS,
                           stream_mean=True, device="cpu")
    mean, var, _ = eng.predict("rbcm", data[2])
    jmean, jvar, _ = jengines[True].predict("rbcm", jnp.asarray(data[2]))
    _close(mean, jmean)
    _close(var, jvar)


@pytest.mark.parametrize("nt", [1, 16, 37])
def test_map_query_tiles_edge_padding(nt):
    """Ragged tails are edge-replicated: the padded slots repeat the last
    real query, as the reference pads."""
    rng = np.random.default_rng(nt)
    Xs = rng.normal(size=(nt, 2))

    def tile(Xq):
        return {"s": Xq.sum(-1)}, {"worst": Xq[:, 0].max()}
    perq, red = map_query_tiles(tile, _t(Xs), CHUNK)
    jperq, jred = jmap_query_tiles(lambda q: ({"s": q.sum(-1)},
                                              {"worst": q[:, 0].max()}),
                                   jnp.asarray(Xs), CHUNK)
    _close(perq["s"], jperq["s"], 1e-15)
    assert float(red["worst"]) == float(jred["worst"])


def test_engine_rejects_unknown_method_and_mismatched_graph(fits):
    _, tf = fits
    eng = PredictionEngine(tf, path_graph(M), device="cpu")
    with pytest.raises(ValueError, match="unknown prediction method"):
        eng.predict("nope", np.zeros((3, 2)))
    with pytest.raises(ValueError, match="fitted_aug and fitted_comm"):
        eng.predict("grbcm", np.zeros((3, 2)))
    with pytest.raises(ValueError, match="adjacency"):
        PredictionEngine(tf, path_graph(M + 1), device="cpu")
