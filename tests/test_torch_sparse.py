"""The port's sparse pseudo-representation experts (repro_torch.core.sparse)
against the JAX package's, on the CPU in float64: the blocked Kmn
statistics, the fit, the served moments, CBNN scores, the low-rank NPAE,
the collapsed bound and its gradients, both sparse trainers, the engine's
sparse dispatch, the registry's sparse rules and GPFleet(sparse_m=...)
end to end. The same numpy arrays go to both packages.

Tolerances. Where the float64 algebra holds it, 1e-9 relative to the
largest reference entry. The fit solves with Sigma = Kmm + Kmn Knm /
sigma_eps^2, and both packages differ in the rounding of their inputs
(the port's plain Gram takes direct differences, the reference's the
||a||^2 + ||b||^2 - 2ab expansion) and of their LAPACK calls, so a result
downstream of Sigma may differ by cond(Sigma) * eps; the tests compute
cond(Sigma + jit I) of every agent and allow max(1e-9, cond * eps). At
m = 8 that is below 1e-9; at m = 32 cond(Sigma) reaches 2e12 on this data
(cond(Kmm + jit I) 5e8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse as JS
from repro.core.prediction import aggregation as jagg
from repro.core.training.admm_decentralized import (
    train_dec_apx_gp as j_train_dec_apx_gp)
from repro.fleet import FleetConfig as JFleetConfig
from repro.fleet import GPFleet as JGPFleet
from repro.fleet import METHODS as J_METHODS
from repro.fleet.registry import SPARSE_TRAINERS as J_SPARSE_TRAINERS
from repro.kernels import ops as jops
from repro_torch.core import sparse as S
from repro_torch.core.consensus import path_graph
from repro_torch.core.prediction import (FittedExperts, PredictionEngine,
                                         fit_experts, local_moments)
from repro_torch.core.prediction.aggregation import npae
from repro_torch.core.training import train_dec_apx_gp
from repro_torch.fleet import (METHODS, FleetConfig, GPFleet, get_method,
                               get_trainer, trainer_names, validate_config)
from repro_torch.fleet import registry
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve_gp

torch.set_num_threads(2)

EPS = np.finfo(np.float64).eps
LOG_THETA = np.log([1.2, 0.3, 1.3, 0.1])
M, NI, NT = 4, 96, 17


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _se(a, b, lt=LOG_THETA):
    d = ((a[..., :, None, :] - b[..., None, :, :]) / np.exp(lt[:-2])) ** 2
    return np.exp(lt[-2]) ** 2 * np.exp(-d.sum(-1))


@pytest.fixture(scope="module")
def data():
    """A GP draw at the true theta on M * NI points of [0, 2)^2, sorted
    into stripes along x1, and NT queries."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 2, (M * NI, 2))
    X = X[np.argsort(X[:, 0])]
    L = np.linalg.cholesky(_se(X, X) + 1e-8 * np.eye(len(X)))
    f = L @ rng.normal(size=len(X))
    y = f + 0.1 * rng.normal(size=len(X))
    return X.reshape(M, NI, 2), y.reshape(M, NI), rng.uniform(0, 2, (NT, 2))


def _tol(Xp, m, lt=LOG_THETA):
    """max(1e-9, cond(Sigma + jit I) * eps) over the agents, for stride
    inducing points at log theta `lt` (see the module docstring)."""
    idx = np.round(np.linspace(0, NI - 1, m)).astype(int)
    Z = Xp[:, idx]
    jit = (1e-8 + 8 * EPS) * np.exp(lt[-2]) ** 2
    Kmn = _se(Z, Xp, lt)
    Sig = _se(Z, Z, lt) + Kmn @ Kmn.transpose(0, 2, 1) / np.exp(lt[-1]) ** 2 \
        + jit * np.eye(m)
    return max(1e-9, float(np.linalg.cond(Sig).max()) * EPS)


def _fits(data, m):
    Xp, yp, _ = data
    fj = JS.fit_sparse_experts(_j(LOG_THETA), _j(Xp), _j(yp),
                               JS.select_inducing(_j(Xp), m))
    fp = S.fit_sparse_experts(_t(LOG_THETA), _t(Xp), _t(yp),
                              S.select_inducing(_t(Xp), m))
    return fp, fj


# ------------------------------------------------------------ statistics

@pytest.mark.parametrize("bn", [17, 32, 4096])
def test_kmn_stats_matches_reference_with_a_ragged_tail(data, bn):
    """B = Kmn Knm and b = Kmn y streamed in panels of bn columns (96 =
    5 x 17 + 11 leaves a tail) against the reference's op and the
    materialized Kmn: 1e-12 relative (sums of at most 96 products)."""
    Xp, yp, _ = data
    Z = Xp[0, ::4]
    ls, sf = np.exp(LOG_THETA[:2]), np.exp(LOG_THETA[2])
    B, b = ops.kmn_stats(_t(Z), _t(Xp[0]), _t(yp[0]), _t(ls), sf, bn=bn)
    Bj, bj = jops.kmn_stats(_j(Z), _j(Xp[0]), _j(yp[0]), _j(ls), sf, bn=bn)
    assert B.dtype == torch.float64
    assert _rel(B, Bj) <= 1e-12 and _rel(b, bj) <= 1e-12
    Br, br = ref.kmn_stats_ref(_t(Z), _t(Xp[0]), _t(yp[0]), _t(ls), sf)
    assert _rel(B, Br) <= 1e-12 and _rel(b, br) <= 1e-12


def test_kmn_stats_agents_equals_per_agent_calls(data):
    """The fleet op against one agent at a time: the same panels, summed
    by batched and unbatched BLAS calls (1e-14 relative)."""
    Xp, yp, _ = data
    Z = _t(Xp[:, ::8])
    ls, sf = _t(np.exp(LOG_THETA[:2])), float(np.exp(LOG_THETA[2]))
    B, b = ops.kmn_stats_agents(Z, _t(Xp), _t(yp), ls, sf, bn=40)
    for i in range(M):
        Bi, bi = ops.kmn_stats(Z[i], _t(Xp[i]), _t(yp[i]), ls, sf, bn=40)
        assert _rel(B[i], Bi) <= 1e-14 and _rel(b[i], bi) <= 1e-14


# ------------------------------------------------------------------- fit

@pytest.mark.parametrize("m", [8, 32])
def test_fit_sparse_experts_matches_reference(data, m):
    fp, fj = _fits(data, m)
    tol = _tol(data[0], m)
    assert isinstance(fp, S.SparseExperts)
    assert torch.equal(fp.Z, _t(fj.Z))
    for name in ("Lmm", "LS", "c"):
        assert _rel(getattr(fp, name), getattr(fj, name)) <= tol, name
    # tr_corr cancels down from Ni sigma_f^2, its scale
    scale = NI * np.exp(LOG_THETA[-2]) ** 2
    assert np.abs(fp.tr_corr.numpy() - np.asarray(fj.tr_corr)).max() \
        <= tol * scale
    assert fp.num_agents == M and fp.Kcross is None and fp.Xp is fp.Z
    assert float(fp.prior_var) == pytest.approx(np.exp(LOG_THETA[-2]) ** 2)


@pytest.mark.parametrize("m", [8, 32])
@pytest.mark.parametrize("stream_mean", [False, True])
def test_sparse_moments_match_reference(data, m, stream_mean):
    fp, fj = _fits(data, m)
    Xs = data[2]
    tol = _tol(data[0], m)
    mu, var = S.sparse_moments_cached(fp.log_theta, fp.Z, fp.Lmm, fp.LS,
                                      fp.c, _t(Xs), stream_mean=stream_mean)
    muj, varj = JS.sparse_moments_cached(fj.log_theta, fj.Z, fj.Lmm, fj.LS,
                                         fj.c, _j(Xs),
                                         stream_mean=stream_mean)
    assert mu.shape == (M, NT) and mu.dtype == torch.float64
    assert _rel(mu, muj) <= tol and _rel(var, varj) <= tol


@pytest.mark.parametrize("m", [8, 32])
def test_sparse_scores_match_reference(data, m):
    fp, fj = _fits(data, m)
    Xs = data[2]
    sc = S.sparse_scores(fp.log_theta, fp.Z, fp.Lmm, fp.LS, _t(Xs))
    scj = JS.sparse_scores(fj.log_theta, fj.Z, fj.Lmm, fj.LS, _j(Xs))
    assert _rel(sc, scj) <= _tol(data[0], m)
    # sigma_f^2 - var, the dense scores' scale
    _, var = S.sparse_moments_cached(fp.log_theta, fp.Z, fp.Lmm, fp.LS,
                                     fp.c, _t(Xs))
    assert torch.allclose(sc, fp.prior_var - var, rtol=0, atol=1e-9)


# ---------------------------------------------------------- low-rank NPAE

@pytest.mark.parametrize("m", [8, 32])
def test_lowrank_npae_factors_match_reference(data, m):
    fp, fj = _fits(data, m)
    Xs = data[2]
    tol = _tol(data[0], m)
    got = S.sparse_npae_factors(fp.log_theta, fp.Z, fp.Lmm, fp.LS, fp.c,
                                _t(Xs))
    want = JS.sparse_npae_factors(fj.log_theta, fj.Z, fj.Lmm, fj.LS, fj.c,
                                  _j(Xs))
    for g, w in zip(got, want):
        assert _rel(g, w) <= tol
    mu, kA, U = got
    CA = S.cross_lowrank(fp.log_theta, fp.Z, U, kA)
    CAj = JS.cross_lowrank(fj.log_theta, fj.Z, want[2], want[1])
    assert CA.shape == (NT, M, M) and _rel(CA, CAj) <= tol
    idx = torch.arange(M)
    assert torch.equal(CA[:, idx, idx], kA.T)
    terms = S.npae_terms_lowrank(fp.log_theta, fp.Z, fp.Lmm, fp.LS, fp.c,
                                 _t(Xs))
    assert all(torch.equal(a, b) for a, b in zip(terms, (mu, kA, CA)))


@pytest.mark.parametrize("m", [8, 32])
def test_dec_npae_sparse_matches_reference(data, m):
    Xp, yp, Xs = data
    mean, var = S.dec_npae_sparse(_t(LOG_THETA), _t(Xp), _t(yp), _t(Xs), m)
    meanj, varj = JS.dec_npae_sparse(_j(LOG_THETA), _j(Xp), _j(yp), _j(Xs),
                                     m)
    tol = _tol(Xp, m)
    assert mean.shape == (NT,) and bool((var > 0).all())
    assert _rel(mean, meanj) <= tol and _rel(var, varj) <= tol


@pytest.mark.parametrize("masked", [False, True])
def test_npae_matches_reference(masked):
    """The aggregation core on random symmetric positive definite C_A:
    1e-9 relative (solves of (M, M) systems with cond below 1e3)."""
    rng = np.random.default_rng(5)
    Mx, Nt = 5, 23
    G = rng.normal(size=(Nt, Mx, Mx))
    CA = G @ G.transpose(0, 2, 1) + Mx * np.eye(Mx)
    mu, kA = rng.normal(size=(Mx, Nt)), rng.normal(size=(Mx, Nt))
    mask = None
    if masked:
        mask = rng.uniform(size=(Mx, Nt)) < 0.6
    got = npae(_t(mu), _t(kA), _t(CA), torch.tensor(30.0),
               mask=None if mask is None else _t(mask), jitter=1e-6)
    want = jagg.npae(_j(mu), _j(kA), _j(CA), 30.0,
                     mask=None if mask is None else _j(mask), jitter=1e-6)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-9


def test_npae_jitter_is_floored_at_eight_eps_in_float32():
    """A relative jitter below float32's ulp is floored at 8 eps(float32),
    as the reference's: both give the same answer in float32 to float32
    rounding (1e-5 relative)."""
    rng = np.random.default_rng(6)
    G = rng.normal(size=(7, 3, 3)).astype(np.float32)
    CA = G @ G.transpose(0, 2, 1) + 3 * np.eye(3, dtype=np.float32)
    mu = rng.normal(size=(3, 7)).astype(np.float32)
    kA = rng.normal(size=(3, 7)).astype(np.float32)
    got = npae(_t(mu), _t(kA), _t(CA), torch.tensor(20.0), jitter=1e-12)
    want = jagg.npae(_j(mu), _j(kA), _j(CA), np.float32(20.0),
                     jitter=1e-12)
    assert got[0].dtype == torch.float32
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5


# ------------------------------------------------------- collapsed bound

@pytest.mark.parametrize("m", [8, 32])
def test_sparse_nll_and_gradients_match_jax_grad(data, m):
    """The bound and its gradients in log theta and Z by torch.autograd
    against jax.grad, per agent."""
    Xp, yp, _ = data
    tol = _tol(Xp, m)
    Zj = JS.select_inducing(_j(Xp), m)
    gj = jax.vmap(jax.grad(JS.sparse_nll, argnums=(0, 1)),
                  in_axes=(None, 0, 0, 0))(_j(LOG_THETA), Zj, _j(Xp),
                                           _j(yp))
    lt = _t(LOG_THETA).requires_grad_(True)
    Z = S.select_inducing(_t(Xp), m).requires_grad_(True)
    vals = S.sparse_nlls(lt, Z, _t(Xp), _t(yp))
    g_lt, g_Z = torch.autograd.grad(vals.sum(), (lt, Z))
    valsj = JS.sparse_nlls(_j(LOG_THETA), Zj, _j(Xp), _j(yp))
    assert vals.shape == (M,) and _rel(vals.detach(), valsj) <= tol
    assert _rel(g_lt, np.asarray(gj[0]).sum(0)) <= tol
    assert _rel(g_Z, gj[1]) <= tol
    one = S.sparse_nll(_t(LOG_THETA), Z[1].detach(), _t(Xp[1]), _t(yp[1]))
    assert float(one) == pytest.approx(float(vals[1].detach()), rel=1e-12)


def test_make_sparse_grad_matches_reference(data):
    Xp, yp, _ = data
    g = S.make_sparse_grad(16)
    gj = JS.make_sparse_grad(16)
    for i in range(M):
        assert _rel(g(_t(LOG_THETA), _t(Xp[i]), _t(yp[i])),
                    gj(_j(LOG_THETA), _j(Xp[i]), _j(yp[i]))) <= 1e-9


def test_collapsed_bound_dominates_the_exact_nll(data):
    """-ELBO_i >= NLL_i (Titsias), tight at m = Ni, on the port alone."""
    from repro_torch.core.training.factorized import local_nlls
    Xp, yp, _ = (_t(a) for a in data)
    lt = _t(LOG_THETA)
    exact = local_nlls(lt, Xp, yp)
    loose = S.sparse_nlls(lt, S.select_inducing(Xp, 8), Xp, yp)
    tight = S.sparse_nlls(lt, S.select_inducing(Xp, NI), Xp, yp)
    assert bool((loose >= exact - 1e-6).all())
    assert bool((tight >= exact - 1e-6).all())
    assert torch.allclose(tight, exact, rtol=1e-3)


# -------------------------------------------------------------- trainers

def test_train_fact_sparse_matches_reference(data):
    """10 Adam steps jointly over (theta, Z), from theta0 (0.8, 0.8, 1.0,
    0.2) and 16 stride inducing points: theta, Z and the per-step bound
    within cond(Sigma) * eps at theta0 (8e-6 here: cond(Sigma) 4e10)."""
    Xp, yp, _ = data
    lt0 = np.log([0.8, 0.8, 1.0, 0.2])
    tol = _tol(Xp, 16, lt0)
    lt, Z, vals = S.train_fact_sparse(_t(lt0), _t(Xp), _t(yp),
                                      S.select_inducing(_t(Xp), 16),
                                      steps=10)
    ltj, Zj, valsj = JS.train_fact_sparse(_j(lt0), _j(Xp), _j(yp),
                                          JS.select_inducing(_j(Xp), 16),
                                          steps=10)
    assert vals.shape == (10,) and float(vals[-1]) < float(vals[0])
    assert _rel(lt, ltj) <= tol and _rel(Z, Zj) <= tol
    assert _rel(vals, valsj) <= tol


def test_dec_apx_sparse_trajectory_matches_reference(data):
    """20 DEC-apx-GP iterations with the collapsed-bound gradient through
    the grad_fn hook (m = 16), from theta0 (2.0, 0.5, 1.0, 1.0): thetas
    and residuals within 1e-6, as the dense DEC-apx trajectory is held."""
    Xp, yp, _ = data
    lt0 = np.log([2.0, 0.5, 1.0, 1.0])
    A = path_graph(M)
    kw = dict(rho=500.0, kappa=5000.0, iters=20)
    th, info = train_dec_apx_gp(_t(lt0), _t(Xp), _t(yp), A,
                                grad_fn=S.make_sparse_grad(16), **kw)
    thj, infoj = j_train_dec_apx_gp(_j(lt0), _j(Xp), _j(yp),
                                    _j(A.numpy()),
                                    grad_fn=JS.make_sparse_grad(16), **kw)
    assert np.abs(th.numpy() - np.asarray(thj)).max() <= 1e-6
    assert np.abs(info["residuals"].numpy()
                  - np.asarray(infoj["residuals"])).max() <= 1e-6


# ------------------------------------------------------------ accuracy

def test_recovers_exact_at_m_eq_ni(data):
    """m = Ni: the Titsias posterior is the exact posterior, up to the
    factorization's conditioning (the reference's bounds)."""
    Xp, yp, Xs = (_t(a) for a in data)
    lt = _t(LOG_THETA)
    sf = S.fit_sparse_experts(lt, Xp, yp, S.select_inducing(Xp, NI))
    mu_s, var_s = S.sparse_moments_cached(lt, sf.Z, sf.Lmm, sf.LS, sf.c, Xs)
    mu_e, var_e = local_moments(lt, Xp, yp, Xs)
    assert float((mu_s - mu_e).abs().max()) < 5e-2
    assert float((var_s - var_e).abs().max()) < 1e-3
    assert float(sf.tr_corr.max()) < 1e-4


def test_accuracy_improves_with_m(data):
    Xp, yp, Xs = (_t(a) for a in data)
    lt = _t(LOG_THETA)
    mu_e, _ = local_moments(lt, Xp, yp, Xs)
    errs, traces = [], []
    for m in (8, 32, NI):
        sf = S.fit_sparse_experts(lt, Xp, yp, S.select_inducing(Xp, m))
        mu_s, _ = S.sparse_moments_cached(lt, sf.Z, sf.Lmm, sf.LS, sf.c, Xs)
        errs.append(float((mu_s - mu_e).abs().max()))
        traces.append(float(sf.tr_corr.mean()))
    assert errs[-1] <= errs[0] and traces[-1] <= traces[0]
    assert traces[-1] < 1e-4


# ----------------------------------------------------- inducing selection

def test_select_inducing_stride_is_the_reference(data):
    Xp = data[0]
    for m in (1, 8, 33, NI, NI + 50):
        assert np.array_equal(S.select_inducing(_t(Xp), m).numpy(),
                              np.asarray(JS.select_inducing(_j(Xp), m)))
    with pytest.raises(ValueError, match="inducing_init"):
        S.select_inducing(_t(Xp), 16, "kmeans")


def test_select_inducing_random_is_a_per_agent_subset():
    """"random" draws m distinct points of each agent's own set, from a
    per-agent stream: the agents' index sets differ on identical data, a
    seed repeats its draw and another seed does not, and over many seeds
    every point is drawn about m / Ni of the time."""
    n, m = 50, 10
    pts = torch.arange(n, dtype=torch.float64)[:, None].expand(n, 2)
    Xp = pts.expand(4, n, 2).contiguous()           # identical agents
    Z = S.select_inducing(Xp, m, "random", seed=7)
    assert Z.shape == (4, m, 2)
    idx = Z[..., 0].long()
    for i in range(4):
        assert len(set(idx[i].tolist())) == m      # without replacement
    assert len({tuple(sorted(r)) for r in idx.tolist()}) == 4
    assert torch.equal(Z, S.select_inducing(Xp, m, "random", seed=7))
    assert not torch.equal(Z, S.select_inducing(Xp, m, "random", seed=8))
    counts = torch.zeros(n)
    seeds = 400
    for s in range(seeds):
        counts += torch.bincount(
            S.select_inducing(Xp[:1], m, "random", seed=s)[0, :, 0].long(),
            minlength=n)
    # each point is a Binomial(400, 0.2) count: mean 80, sd 8; 6 sd
    assert float((counts - seeds * m / n).abs().max()) < 6 * 8.0


# ----------------------------------------------------------- the engine

@pytest.mark.parametrize("method", ["rbcm", "gpoe", "poe", "bcm",
                                    "npae_sparse", "cen_rbcm"])
def test_engine_serves_sparse_experts_like_reference(data, method):
    from repro.core.consensus import path_graph as jpath
    from repro.core.prediction import PredictionEngine as JEngine
    fp, fj = _fits(data, 8)
    Xs = data[2]
    eng = PredictionEngine(fp, path_graph(M), chunk=8, dac_iters=150,
                           device="cpu")
    mean, var, _ = eng.predict(method, Xs)
    jeng = JEngine(fj, jpath(M), chunk=8, dac_iters=150)
    meanj, varj, _ = jeng.predict(method, _j(Xs))
    assert _rel(mean, meanj) <= 1e-9 and _rel(var, varj) <= 1e-9


def test_engine_sparse_rejections_and_streamed_means(data):
    fp, _ = _fits(data, 8)
    Xp, yp, Xs = (_t(a) for a in data)
    eng = PredictionEngine(fp, path_graph(M), chunk=8, device="cpu")
    for method in registry._DENSE_ONLY + ("cen_npae",):
        with pytest.raises(ValueError, match="dense O.M.2 Ni.2. cross-Gram"):
            eng.predict(method, Xs)
    dense = PredictionEngine(fit_experts(_t(LOG_THETA), Xp, yp),
                             path_graph(M), chunk=8, device="cpu")
    with pytest.raises(ValueError, match="SparseExperts"):
        dense.predict("npae_sparse", Xs)
    mu = PredictionEngine(fp, path_graph(M), device="cpu") \
        .posterior_means_streamed(Xs)
    mu_ref, _ = S.sparse_moments_cached(fp.log_theta, fp.Z, fp.Lmm, fp.LS,
                                        fp.c, Xs)
    assert _rel(mu, mu_ref) <= 1e-12
    with pytest.raises(TypeError, match="FittedExperts"):
        eng.swap_experts(fp)
    assert isinstance(fit_experts(_t(LOG_THETA), Xp, yp), FittedExperts)


# ------------------------------------------------------------- registry

def test_registry_sparse_flags_match_reference():
    assert set(METHODS) == set(J_METHODS)
    for name, spec in METHODS.items():
        assert spec.sparse == J_METHODS[name].sparse, name
        assert spec.family == J_METHODS[name].family, name
    assert set(registry._DENSE_ONLY) == {
        n for n, s in J_METHODS.items() if not s.sparse}
    assert set(registry.SPARSE_TRAINERS) == set(J_SPARSE_TRAINERS)
    assert set(registry.SPARSE_TRAINERS) <= set(trainer_names())
    assert get_method("npae-sparse") is get_method("npae_sparse")
    assert FleetConfig(method="npae-sparse", sparse_m=8).method == \
        "npae_sparse"


@pytest.mark.parametrize("cfg_kw, frag", [
    (dict(trainer="fact-sparse"), "sparse_m"),
    (dict(trainer="dec-apx-sparse"), "sparse_m"),
    (dict(method="npae_sparse"), "sparse_m"),
    (dict(method="npae", sparse_m=16), "dense"),
    (dict(method="nn_npae", sparse_m=16), "dense"),
    (dict(method="rbcm", sparse_m=16, online=True), "online"),
    (dict(method="npae", sparse_m=16, cache_cross=True), None),
])
def test_validate_config_sparse_rules(cfg_kw, frag):
    """The reference's sparse rules, as its tests/test_sparse.py states
    them, on the port and on the reference alike."""
    for validate, cls in ((validate_config, FleetConfig), (None, None)):
        if validate is None:
            from repro.fleet import validate_config as validate
            from repro.fleet import FleetConfig as cls
        with pytest.raises(ValueError) as e:
            validate(cls(num_agents=M, **cfg_kw))
        if frag is not None:
            assert frag in str(e.value)


def test_validate_config_accepts_sparse_combos():
    for kw in (dict(trainer="fact-sparse", method="npae_sparse",
                    sparse_m=16),
               dict(trainer="dec-apx-sparse", method="rbcm", sparse_m=16),
               dict(method="gpoe", sparse_m=3)):
        validate_config(FleetConfig(num_agents=M, **kw))
        GPFleet(FleetConfig(num_agents=M, **kw), device="cpu")
    for name in ("fact-sparse", "dec-apx-sparse"):
        assert get_trainer(name).name == name


# ---------------------------------------------------------------- fleet

def _fleets(data, train, **kw):
    Xp, yp, _ = data
    fleet = GPFleet(FleetConfig(**kw), device="cpu").fit(
        Xp, yp, log_theta0=LOG_THETA, train=train)
    jfleet = JGPFleet(JFleetConfig(**kw)).fit(
        _j(Xp), _j(yp), log_theta0=_j(LOG_THETA), train=train)
    return fleet, jfleet


@pytest.mark.parametrize("m", [8, 32])
@pytest.mark.parametrize("method", ["rbcm", "npae_sparse"])
def test_fleet_sparse_serves_like_reference(data, m, method):
    """GPFleet(sparse_m=m).fit(train=False).predict against the JAX
    GPFleet, with the streamed mean."""
    kw = dict(sparse_m=m, method=method, chunk=8, dac_iters=150,
              stream_mean=True)
    fleet, jfleet = _fleets(data, False, **kw)
    assert isinstance(fleet.fitted, S.SparseExperts)
    mean, var, _ = fleet.predict(data[2])
    meanj, varj, _ = jfleet.predict(_j(data[2]))
    tol = _tol(data[0], m)
    assert _rel(mean, meanj) <= tol and _rel(var, varj) <= tol


@pytest.mark.parametrize("trainer,method", [
    ("fact-sparse", "npae_sparse"), ("fact-sparse", "rbcm"),
    ("dec-apx-sparse", "rbcm"), ("dec-apx-sparse", "npae_sparse")])
def test_fleet_sparse_trainers_match_reference(data, trainer, method):
    """Training then serving: fact-sparse (8 Adam steps, the optimized Z
    served) and dec-apx-sparse (5 ADMM iterations) at m = 16, against the
    JAX GPFleet: theta and Z within cond(Sigma) * eps at the true theta
    (fact-sparse, 2e-7: cond(Sigma) 9e8) or 1e-6 (dec-apx-sparse, the
    trajectory bound above), served moments 1e-6."""
    kw = dict(sparse_m=16, trainer=trainer, method=method, chunk=8,
              dac_iters=150, fact_steps=8, admm_iters=5)
    fleet, jfleet = _fleets(data, True, **kw)
    theta_tol = _tol(data[0], 16) if trainer == "fact-sparse" else 1e-6
    assert np.abs(fleet.log_theta.numpy()
                  - np.asarray(jfleet.log_theta)).max() <= theta_tol
    if trainer == "fact-sparse":
        assert _rel(fleet.fitted.Z, jfleet.fitted.Z) <= theta_tol
        assert torch.equal(fleet.fitted.Z, fleet.train_info["Z"])
    mean, var, _ = fleet.predict(data[2])
    meanj, varj, _ = jfleet.predict(_j(data[2]))
    assert _rel(mean, meanj) <= 1e-6 and _rel(var, varj) <= 1e-6


@pytest.mark.parametrize("dtype,method", [("float32", "npae-sparse"),
                                          ("float64", "rbcm")])
def test_serve_gp_sparse_on_the_cpu(capsys, dtype, method):
    serve_gp.main(["--device", "cpu", "--agents", "4", "--per-agent", "64",
                   "--requests", "4", "--batch", "32", "--chunk", "16",
                   "--sparse-m", "16", "--method", method, "--dtype", dtype])
    out = capsys.readouterr().out
    assert f"sparse m=16, {dtype}" in out
    assert f"{method.replace('-', '_')}: served" in out
