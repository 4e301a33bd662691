"""Parity of the port's CBNN, grBCM and dense NPAE (repro_torch.core.
prediction: cbnn, local.npae_terms*, aggregation.grbcm, the dec_* methods
and PredictionEngine) with the JAX package, on the same float64 numpy
inputs: every one of the paper's 13 decentralized methods and the
centralized references cen_grbcm and cen_npae.

Tolerances. 1e-9 relative to max|reference| for the dense paths (same
float64 algorithms through different LAPACK/BLAS builds, as in
tests/test_torch_prediction.py); CBNN masks bit for bit; the factors of
the C5 repair (two triangular solves, not torch.cholesky_solve) 1e-12.
Sparse fleets: max(1e-9, cond(Sigma + jit I) * eps) over the fitted
agents, as tests/test_torch_sparse.py derives it. The iteration counts
are short (the residuals are not converged), which holds the port to the
reference's iterates, not only to the fixed point.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse as JS
from repro.core.consensus import path_graph as jpath_graph
from repro.core.gp import augment as jaugment
from repro.core.prediction import PredictionEngine as JEngine
from repro.core.prediction import aggregation as jagg
from repro.core.prediction import cbnn as jcbnn
from repro.core.prediction import decentralized as jdec
from repro.core.prediction import fit_experts as jfit_experts
from repro.core.prediction import local as jlocal
from repro_torch.core import sparse as S
from repro_torch.core.consensus import path_graph
from repro_torch.core.gp import cho_solve
from repro_torch.core.prediction import PredictionEngine, fit_experts
from repro_torch.core.prediction import aggregation as tagg
from repro_torch.core.prediction import cbnn as tcbnn
from repro_torch.core.prediction import decentralized as tdec
from repro_torch.core.prediction import local as tlocal

torch.set_num_threads(2)

TOL = 1e-9
EPS = np.finfo(np.float64).eps
M, NI, NT, CHUNK = 4, 40, 13, 8                  # NT ragged over CHUNK
ITERS = dict(dac_iters=120, jor_iters=150, dale_iters=300, pm_iters=40)
ETA = 0.5                                        # about 3 of 4 agents kept
LOG_THETA = np.log([1.2, 0.3, 1.3, 0.1])
DENSE_METHODS = ("poe", "gpoe", "bcm", "rbcm", "grbcm", "npae",
                 "npae_star", "nn_poe", "nn_gpoe", "nn_bcm", "nn_rbcm",
                 "nn_grbcm", "nn_npae", "cen_poe", "cen_gpoe", "cen_bcm",
                 "cen_rbcm", "cen_grbcm", "cen_npae")


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def _close_residual(got, want):
    """Consensus residuals: 1e-6 relative, or 1e-12 absolute once they
    reach the payloads' rounding (a converged DAC spread is a few 1e-10
    here, the rounding of payloads up to ~1e3)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= 1e-6 * np.abs(want) + 1e-12).all()


@pytest.fixture(scope="module")
def data():
    """Stripes of a smooth noisy field over [0, 2]^2, ragged queries, and
    a communication dataset drawn with numpy (N_i / M points per agent
    without replacement) with the augmented datasets."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 2, (M * NI, 2))
    X = X[np.argsort(X[:, 0])]
    y = np.sin(2 * X[:, 0]) * np.cos(3 * X[:, 1]) \
        + 0.1 * rng.normal(size=M * NI)
    Xp, yp = X.reshape(M, NI, 2), y.reshape(M, NI)
    idx = np.stack([rng.choice(NI, NI // M, replace=False)
                    for _ in range(M)])
    Xc = np.concatenate([Xp[i, idx[i]] for i in range(M)])
    yc = np.concatenate([yp[i, idx[i]] for i in range(M)])
    Xa, ya = (np.asarray(a) for a in jaugment(_j(Xp), _j(yp), _j(Xc),
                                              _j(yc)))
    return dict(Xp=Xp, yp=yp, Xs=rng.uniform(0, 2, (NT, 2)), Xc=Xc, yc=yc,
                Xa=Xa, ya=ya)


@pytest.fixture(scope="module")
def engines(data):
    d = data
    lt = LOG_THETA
    jfit = lambda X, y: jfit_experts(_j(lt), _j(X), _j(y))   # noqa: E731
    tfit = lambda X, y: fit_experts(_t(lt), _t(X), _t(y))    # noqa: E731
    kw = dict(chunk=CHUNK, eta_nn=ETA, **ITERS)
    out = {}
    for stream in (False, True):
        je = JEngine(jfit(d["Xp"], d["yp"]), jpath_graph(M),
                     fitted_aug=jfit(d["Xa"], d["ya"]),
                     fitted_comm=jfit(d["Xc"][None], d["yc"][None]),
                     stream_mean=stream, **kw)
        te = PredictionEngine(tfit(d["Xp"], d["yp"]), path_graph(M),
                              fitted_aug=tfit(d["Xa"], d["ya"]),
                              fitted_comm=tfit(d["Xc"][None], d["yc"][None]),
                              stream_mean=stream, device="cpu", **kw)
        out[stream] = (te, je)
    return out


# -------------------------------------------------------------- factors

def test_chol_factors_two_triangular_solves_match_reference(data):
    """The C5 repair: alpha by two triangular solves, to 1e-12."""
    L, alpha = tlocal.chol_factors(_t(LOG_THETA), _t(data["Xa"]),
                                   _t(data["ya"]))
    Lj, alphaj = jlocal.chol_factors(_j(LOG_THETA), _j(data["Xa"]),
                                     _j(data["ya"]))
    _close(L, Lj, 1e-12)
    _close(alpha, alphaj, 1e-12)
    B = np.random.default_rng(1).normal(size=(M, 2 * NI, 3))
    _close(cho_solve(L, _t(B)),
           np.linalg.solve(np.asarray(Lj) @ np.asarray(Lj).transpose(0, 2, 1),
                           B), 1e-10)


# ----------------------------------------------------------------- CBNN

def test_cbnn_scores_and_masks_match_reference(data):
    """Scores to 1e-9 (one triangular solve against the reference's two),
    cached and per call; masks bit for bit, at several thresholds."""
    lt, Xp, yp, Xs = _t(LOG_THETA), _t(data["Xp"]), _t(data["yp"]), \
        _t(data["Xs"])
    L, _ = tlocal.chol_factors(lt, Xp, yp)
    Lj, _ = jlocal.chol_factors(_j(LOG_THETA), _j(data["Xp"]),
                                _j(data["yp"]))
    scores = tcbnn.cbnn_scores_cached(lt, Xp, L, Xs)
    scoresj = jcbnn.cbnn_scores_cached(_j(LOG_THETA), _j(data["Xp"]), Lj,
                                       _j(data["Xs"]))
    _close(scores, scoresj)
    _close(tcbnn.cbnn_scores(lt, Xp, Xs), scoresj)
    for eta in (0.0, 0.3, ETA, 1.0, 10.0):
        mask, s = tcbnn.cbnn_mask_cached(lt, Xp, L, Xs, eta)
        maskj, _ = jcbnn.cbnn_mask_cached(_j(LOG_THETA), _j(data["Xp"]),
                                          Lj, _j(data["Xs"]), eta)
        assert mask.dtype == torch.bool
        np.testing.assert_array_equal(mask.numpy(), np.asarray(maskj))
        assert bool(mask.any(0).all())              # >= 1 agent per query
        maskc, _ = tcbnn.cbnn_mask(lt, Xp, Xs, eta)
        np.testing.assert_array_equal(maskc.numpy(), np.asarray(maskj))


def test_mask_from_scores_keeps_every_tied_best_agent():
    scores = torch.tensor([[0.2, 0.05], [0.2, 0.01], [0.1, 0.05]])
    mask = tcbnn._mask_from_scores(scores, 0.5)
    maskj = jcbnn._mask_from_scores(_j(scores.numpy()), 0.5)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(maskj))
    assert mask.tolist() == [[True, True], [True, False], [False, True]]


# ----------------------------------------------------------- NPAE terms

@pytest.mark.parametrize("cached_cross", [False, True])
def test_npae_terms_cached_match_reference(data, cached_cross):
    lt, Xp, yp, Xs = _t(LOG_THETA), _t(data["Xp"]), _t(data["yp"]), \
        _t(data["Xs"])
    L, alpha = tlocal.chol_factors(lt, Xp, yp)
    Lj, alphaj = jlocal.chol_factors(_j(LOG_THETA), _j(data["Xp"]),
                                     _j(data["yp"]))
    Kc = tlocal.cross_gram(lt, Xp) if cached_cross else None
    Kcj = jlocal.cross_gram(_j(LOG_THETA), _j(data["Xp"])) \
        if cached_cross else None
    if cached_cross:
        _close(Kc, Kcj)
    got = tlocal.npae_terms_cached(lt, Xp, L, alpha, Xs, Kcross=Kc)
    want = jlocal.npae_terms_cached(_j(LOG_THETA), _j(data["Xp"]), Lj,
                                    alphaj, _j(data["Xs"]), Kcross=Kcj)
    for g, w in zip(got, want):
        _close(g, w)
    _close(torch.diagonal(got[2], dim1=-2, dim2=-1), got[1].T, 0)
    for g, w in zip(tlocal.npae_terms(lt, Xp, yp, Xs),
                    jlocal.npae_terms(_j(LOG_THETA), _j(data["Xp"]),
                                      _j(data["yp"]), _j(data["Xs"]))):
        _close(g, w)


# ---------------------------------------------------------- aggregation

@pytest.mark.parametrize("mask_kind", [None, "agents", "per_query"])
def test_aggregation_grbcm_matches_reference(mask_kind):
    rng = np.random.default_rng(7)
    mu, mu_c = rng.normal(size=(M, NT)), rng.normal(size=NT)
    var = rng.uniform(0.01, 0.5, (M, NT))
    var_c = rng.uniform(0.05, 0.6, NT)
    mask = {None: None, "agents": np.array([1.0, 0.0, 1.0, 1.0]),
            "per_query": (rng.uniform(size=(M, NT)) < 0.7).astype(float)
            }[mask_kind]
    got = tagg.grbcm(_t(mu), _t(var), _t(mu_c), _t(var_c),
                     None if mask is None else _t(mask))
    want = jagg.grbcm(_j(mu), _j(var), _j(mu_c), _j(var_c),
                      None if mask is None else _j(mask))
    for g, w in zip(got, want):
        _close(g, w)


# --------------------------------------------------------------- engine

@pytest.mark.parametrize("method", DENSE_METHODS)
def test_engine_matches_reference(engines, data, method):
    """All 13 decentralized methods and every centralized reference
    through PredictionEngine against the reference engine: mean, var,
    the CBNN mask and the final consensus residuals."""
    te, je = engines[False]
    mean, var, info = te.predict(method, data["Xs"])
    meanj, varj, infoj = je.predict(method, _j(data["Xs"]))
    _close(mean, meanj)
    _close(var, varj)
    assert set(info) == set(infoj)
    if "mask" in info:
        np.testing.assert_array_equal(info["mask"].numpy(),
                                      np.asarray(infoj["mask"]))
    for key in ("dac_residual", "jor_residual", "dale_residual"):
        if key in info:
            _close_residual(info[key], infoj[key])


@pytest.mark.parametrize("method", ["grbcm", "nn_grbcm", "cen_grbcm",
                                    "nn_rbcm"])
def test_engine_streamed_means_match_reference(engines, data, method):
    """With stream_mean the grbcm methods stream the augmented experts
    and the communication expert (M = 1) through rbf_matvec."""
    te, je = engines[True]
    for got, want in zip(te.predict(method, data["Xs"])[:2],
                         je.predict(method, _j(data["Xs"]))[:2]):
        _close(got, want)


def test_engine_npae_with_cross_gram_cache_matches_reference(data):
    lt = LOG_THETA
    tf = fit_experts(_t(lt), _t(data["Xp"]), _t(data["yp"]),
                     cache_cross=True)
    jf = jfit_experts(_j(lt), _j(data["Xp"]), _j(data["yp"]),
                      cache_cross=True)
    _close(tf.Kcross, jf.Kcross)
    te = PredictionEngine(tf, path_graph(M), chunk=CHUNK, device="cpu",
                          **ITERS)
    je = JEngine(jf, jpath_graph(M), chunk=CHUNK, **ITERS)
    for method in ("npae", "cen_npae"):
        for got, want in zip(te.predict(method, data["Xs"])[:2],
                             je.predict(method, _j(data["Xs"]))[:2]):
            _close(got, want)


def test_fit_experts_cross_cache_guard_matches_reference(data):
    """The cache's size guard raises before anything is built, with the
    reference's message."""
    lt, Xp, yp = _t(LOG_THETA), _t(data["Xp"]), _t(data["yp"])
    with pytest.raises(ValueError, match="cache_cross would materialize") \
            as e:
        fit_experts(lt, Xp, yp, cache_cross=True, cross_cache_limit_mb=0.1)
    with pytest.raises(ValueError) as ej:
        jfit_experts(_j(LOG_THETA), _j(data["Xp"]), _j(data["yp"]),
                     cache_cross=True, cross_cache_limit_mb=0.1)
    assert str(e.value) == str(ej.value)
    assert fit_experts(lt, Xp, yp).Kcross is None


def test_engine_rejections(data):
    lt = _t(LOG_THETA)
    f = fit_experts(lt, _t(data["Xp"]), _t(data["yp"]))
    eng = PredictionEngine(f, path_graph(M), device="cpu")
    for method in ("grbcm", "nn_grbcm", "cen_grbcm"):
        with pytest.raises(ValueError, match="fitted_aug and fitted_comm"):
            eng.predict(method, data["Xs"])
    sp = S.fit_sparse_experts(lt, _t(data["Xp"]), _t(data["yp"]),
                              S.select_inducing(_t(data["Xp"]), 8))
    seng = PredictionEngine(sp, path_graph(M), device="cpu")
    for method in ("npae", "npae_star", "nn_npae", "cen_npae"):
        with pytest.raises(ValueError, match="npae_sparse"):
            seng.predict(method, data["Xs"])


# ---------------------------------------------------------- per-call API

def _legacy(d, A, Aj):
    """(port call, reference call) per per-call wrapper."""
    lt, ltj = _t(LOG_THETA), _j(LOG_THETA)
    tX, tY, tS = _t(d["Xp"]), _t(d["yp"]), _t(d["Xs"])
    jX, jY, jS = _j(d["Xp"]), _j(d["yp"]), _j(d["Xs"])
    aug_t = (_t(d["Xa"]), _t(d["ya"]), _t(d["Xc"]), _t(d["yc"]))
    aug_j = (_j(d["Xa"]), _j(d["ya"]), _j(d["Xc"]), _j(d["yc"]))
    it = ITERS["dac_iters"]
    calls = {}
    for name in ("poe", "gpoe", "bcm", "rbcm"):
        tf, jf = getattr(tdec, f"dec_{name}"), getattr(jdec, f"dec_{name}")
        calls[name] = (lambda tf=tf: tf(lt, tX, tY, tS, A, it),
                       lambda jf=jf: jf(ltj, jX, jY, jS, Aj, it))
        tf, jf = getattr(tdec, f"dec_nn_{name}"), \
            getattr(jdec, f"dec_nn_{name}")
        calls[f"nn_{name}"] = (
            lambda tf=tf: tf(lt, tX, tY, tS, A, ETA, it),
            lambda jf=jf: jf(ltj, jX, jY, jS, Aj, ETA, it))
    calls["grbcm"] = (lambda: tdec.dec_grbcm(lt, *aug_t, tS, A, it),
                      lambda: jdec.dec_grbcm(ltj, *aug_j, jS, Aj, it))
    calls["nn_grbcm"] = (
        lambda: tdec.dec_nn_grbcm(lt, *aug_t, tS, A, ETA, it, Xp=tX),
        lambda: jdec.dec_nn_grbcm(ltj, *aug_j, jS, Aj, ETA, it, Xp=jX))
    kw = dict(jor_iters=ITERS["jor_iters"], dac_iters=it)
    calls["npae"] = (lambda: tdec.dec_npae(lt, tX, tY, tS, A, **kw),
                     lambda: jdec.dec_npae(ltj, jX, jY, jS, Aj, **kw))
    calls["npae_star"] = (
        lambda: tdec.dec_npae_star(lt, tX, tY, tS, A, pm_iters=40, **kw),
        lambda: jdec.dec_npae_star(ltj, jX, jY, jS, Aj, pm_iters=40, **kw))
    calls["nn_npae"] = (
        lambda: tdec.dec_nn_npae(lt, tX, tY, tS, A, ETA, dale_iters=300),
        lambda: jdec.dec_nn_npae(ltj, jX, jY, jS, Aj, ETA, dale_iters=300))
    return calls


@pytest.mark.parametrize("name", ["poe", "gpoe", "bcm", "rbcm", "grbcm",
                                  "npae", "npae_star", "nn_poe", "nn_gpoe",
                                  "nn_bcm", "nn_rbcm", "nn_grbcm",
                                  "nn_npae"])
def test_per_call_dec_methods_match_reference(data, name):
    A = path_graph(M)
    port, reference = _legacy(data, A, _j(A.numpy()))[name]
    mean, var, info = port()
    meanj, varj, infoj = reference()
    _close(mean, meanj)
    _close(var, varj)
    if "mask" in infoj:
        np.testing.assert_array_equal(info["mask"].numpy(),
                                      np.asarray(infoj["mask"]))
    for key in ("dac_residuals", "jor_residual", "dale_residual"):
        if key in infoj:
            _close_residual(info[key], infoj[key])
    if "omega" in infoj:
        _close(info["omega"], infoj["omega"])


def test_npae_residual_trajectories_and_readout_match_reference(data):
    """with_residuals adds the per-round JOR trajectory; DEC-NN-NPAE's
    readout restricts the averaged solution copies."""
    lt, Xp, yp, Xs = _t(LOG_THETA), _t(data["Xp"]), _t(data["yp"]), \
        _t(data["Xs"])
    mu, kA, CA = tlocal.npae_terms(lt, Xp, yp, Xs)
    muj, kAj, CAj = jlocal.npae_terms(_j(LOG_THETA), _j(data["Xp"]),
                                      _j(data["yp"]), _j(data["Xs"]))
    A, Aj = path_graph(M), jpath_graph(M)
    pv = float(np.exp(LOG_THETA[-2]) ** 2)
    got = tdec.dec_npae_from_terms(mu, kA, CA, pv, A, jor_iters=60,
                                   dac_iters=50, with_residuals=True)
    want = jdec.dec_npae_from_terms(muj, kAj, CAj, pv, Aj, jor_iters=60,
                                    dac_iters=50, with_residuals=True)
    _close_residual(got[2]["jor_residuals"], want[2]["jor_residuals"])
    _close(got[0], want[0])
    mask = tcbnn.cbnn_mask(lt, Xp, Xs, ETA)[0]
    readout = torch.tensor([1.0, 1.0, 0.0, 1.0], dtype=torch.float64)
    got = tdec.dec_nn_npae_from_terms(mask, mu, kA, CA, pv, A,
                                      dale_iters=200, readout=readout)
    want = jdec.dec_nn_npae_from_terms(_j(mask.numpy()), muj, kAj, CAj, pv,
                                       Aj, dale_iters=200,
                                       readout=_j(readout.numpy()))
    _close(got[0], want[0])
    _close(got[1], want[1])


# ---------------------------------------------------------------- sparse

def _sparse_tol(*Xs, m, lt=LOG_THETA):
    """max(1e-9, cond(Sigma + jit I) * eps) over every fitted agent of
    every expert set (stride inducing points; tests/test_torch_sparse.py)."""
    def se(a, b):
        d = ((a[..., :, None, :] - b[..., None, :, :]) / np.exp(lt[:-2])) ** 2
        return np.exp(lt[-2]) ** 2 * np.exp(-d.sum(-1))
    conds = []
    for X in Xs:
        n = X.shape[1]
        Z = X[:, np.round(np.linspace(0, n - 1, m)).astype(int)]
        jit = (1e-8 + 8 * EPS) * np.exp(lt[-2]) ** 2
        Kmn = se(Z, X)
        Sig = se(Z, Z) + Kmn @ Kmn.transpose(0, 2, 1) / np.exp(lt[-1]) ** 2 \
            + jit * np.eye(m)
        conds.append(float(np.linalg.cond(Sig).max()))
    return max(1e-9, max(conds) * EPS)


@pytest.mark.parametrize("method", ["grbcm", "nn_poe", "nn_gpoe", "nn_bcm",
                                    "nn_rbcm", "nn_grbcm", "cen_grbcm"])
def test_sparse_engine_nn_and_grbcm_match_reference(data, method):
    m = 8
    lt = LOG_THETA

    def fits(X, y):
        return (S.fit_sparse_experts(_t(lt), _t(X), _t(y),
                                     S.select_inducing(_t(X), m)),
                JS.fit_sparse_experts(_j(lt), _j(X), _j(y),
                                      JS.select_inducing(_j(X), m)))
    (tb, jb), (ta, ja), (tc, jc) = (
        fits(data["Xp"], data["yp"]), fits(data["Xa"], data["ya"]),
        fits(data["Xc"][None], data["yc"][None]))
    kw = dict(chunk=CHUNK, dac_iters=ITERS["dac_iters"], eta_nn=ETA)
    te = PredictionEngine(tb, path_graph(M), fitted_aug=ta, fitted_comm=tc,
                          device="cpu", **kw)
    je = JEngine(jb, jpath_graph(M), fitted_aug=ja, fitted_comm=jc, **kw)
    mean, var, info = te.predict(method, data["Xs"])
    meanj, varj, infoj = je.predict(method, _j(data["Xs"]))
    tol = _sparse_tol(data["Xp"], data["Xa"], data["Xc"][None], m=m)
    _close(mean, meanj, tol)
    _close(var, varj, tol)
    if "mask" in infoj:
        np.testing.assert_array_equal(info["mask"].numpy(),
                                      np.asarray(infoj["mask"]))
