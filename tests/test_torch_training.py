"""The port's training slice (repro_torch.core.gp.nll, core.training,
optim.adam, kernels.nll_grad, GPFleet.fit(train=True)) against the JAX
package on the same numpy inputs.

Tolerances: 1e-12 relative in float64 where both packages run the same
algorithm on one agent's small matrices (the LAPACK and BLAS calls differ,
so results differ by rounding only); 1e-6 on the DEC-apx-GP trajectory
over 100 iterations (ROADMAP queue A item 2); 1e-9 over a few iterations
of the other trainers and for the trained fleet's predictions; the float32
plain version against the Pallas kernel in interpret mode at the tolerance
tests/test_training_fused.py uses for that kernel.
"""
import warnings
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.gp as jgp
import repro.core.training as jtr
from repro.core.consensus import path_graph as jpath_graph
from repro.fleet import FleetConfig as JFleetConfig
from repro.fleet import GPFleet as JGPFleet
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.optim import adam as jadam
from repro.optim import apply_updates as japply
from repro_torch.core.consensus import path_graph
from repro_torch.core.gp import (cov_grads, diff2_stack, effective_jitter,
                                 inner_from_cov, nll, nll_from_cov,
                                 nll_grad_analytic)
from repro_torch.core.gp.nll import _inner_from_factor, cholesky
from repro_torch.core.training import (TrainingCache, build_training_cache,
                                       cov_from_cache, make_local_grad,
                                       nll_from_cache, nll_grad_cached,
                                       train_apx_gp, train_c_gp,
                                       train_dec_apx_gp, train_dec_c_gp,
                                       train_dec_gapx_gp, train_fact_gp)
from repro_torch.fleet import FleetConfig, GPFleet
from repro_torch.kernels import nll_grad as G
from repro_torch.kernels import ops, ref
from repro_torch.obs import default_registry
from repro_torch.optim import adam, apply_updates

torch.set_num_threads(2)

# the module, which repro.core.gp's `nll` function shadows
jnll = import_module("repro.core.gp.nll")
LT0 = np.log([2.0, 0.5, 1.0, 1.0])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _agents(M=4, N=40, D=2, seed=0, dtype=np.float64):
    """Stripe-partitioned inputs on [0, 2]^D and a smooth noisy target."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 2, (M * N, D))
    X = X[np.argsort(X[:, 0])]
    y = np.sin(2 * X[:, 0]) * np.cos(X[:, -1]) + 0.1 * rng.normal(size=M * N)
    return (X.reshape(M, N, D).astype(dtype), y.reshape(M, N).astype(dtype))


def _lt(D, seed=1):
    """A log theta (D+2,) with lengthscales spread around 1."""
    rng = np.random.default_rng(seed)
    return np.log(np.concatenate([rng.uniform(0.6, 1.6, D), [1.1, 0.4]]))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _per_agent(fn, *arrays):
    """The JAX function applied agent by agent, stacked."""
    return np.stack([np.asarray(fn(*(jnp.asarray(a[i]) for a in arrays)))
                     for i in range(arrays[0].shape[0])])


# -- core/gp: geometry, covariance derivatives, NLL and its gradients --------

@pytest.mark.parametrize("D", [1, 2, 3])
def test_diff2_stack_and_cov_grads_match_reference(D):
    Xp, _ = _agents(N=33, D=D)
    lt = _lt(D)
    got = diff2_stack(torch.from_numpy(Xp))
    assert got.shape == (4, D, 33, 33) and got.is_contiguous()
    assert _rel(got, _per_agent(jgp.diff2_stack, Xp)) <= 1e-12
    lts = np.stack([lt, lt + 0.1, lt - 0.1, lt + 0.2])
    got = cov_grads(*_t(Xp, lts))
    assert got.shape == (4, D + 2, 33, 33)
    assert _rel(got, _per_agent(jgp.cov_grads, Xp, lts)) <= 1e-12


def test_effective_jitter_is_relative_floored_and_detached():
    lt = torch.tensor(_lt(2), requires_grad=True)
    for dtype, jdtype in ((torch.float64, jnp.float64),
                          (torch.float32, jnp.float32)):
        for jitter in (1e-8, 1e-3):
            got = effective_jitter(lt, dtype, jitter)
            want = jnll.effective_jitter(jnp.asarray(_lt(2)), jdtype,
                                            jitter)
            assert abs(float(got) - float(want)) <= 1e-12 * float(want)
    assert not effective_jitter(lt, torch.float64).requires_grad
    batch = effective_jitter(torch.tensor(np.stack([_lt(2), _lt(2, 3)])),
                             torch.float64)
    assert batch.shape == (2,)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_nll_and_gradients_match_reference(D):
    """nll, its autograd gradient and the analytic trace-identity gradient,
    per agent (one theta row each) and with one shared theta."""
    Xp, yp = _agents(N=40, D=D, seed=D)
    lt = _lt(D)
    lts = np.stack([lt, lt + 0.05, lt - 0.05, lt + 0.1])
    Xt, yt, ltt = _t(Xp, yp, lts)
    assert _rel(nll(ltt, Xt, yt), _per_agent(jgp.nll, lts, Xp, yp)) <= 1e-12
    assert _rel(nll(torch.from_numpy(lt), Xt, yt),
                _per_agent(lambda X, y: jgp.nll(jnp.asarray(lt), X, y),
                           Xp, yp)) <= 1e-12
    assert _rel(nll_grad_analytic(ltt, Xt, yt),
                _per_agent(jgp.nll_grad_analytic, lts, Xp, yp)) <= 1e-12
    prepare, grad = make_local_grad("autodiff")
    assert _rel(grad(ltt, prepare(Xt, yt)),
                _per_agent(jax.grad(jgp.nll), lts, Xp, yp)) <= 1e-12


def test_failed_float32_factorization_gives_nan_like_the_reference():
    """jnp.linalg.cholesky returns NaN on a matrix that is not positive
    definite, where torch.linalg.cholesky would raise: the port follows
    the reference, so a bad iterate propagates as NaN."""
    C = np.array([[1.0, 2.0], [2.0, 1.0]], np.float32)
    y = np.array([0.5, -0.25], np.float32)
    got = nll_from_cov(*_t(C, y))
    want = jnll.nll_from_cov(jnp.asarray(C), jnp.asarray(y))
    assert np.isnan(float(want)) and torch.isnan(got)
    assert bool(torch.isnan(inner_from_cov(*_t(C, y))).all())
    assert np.isnan(np.asarray(jnll.inner_from_cov(jnp.asarray(C),
                                                      jnp.asarray(y)))).all()
    # a batch: only the agent whose factor failed turns NaN
    good = np.array([[2.0, 0.5], [0.5, 1.0]], np.float32)
    both = nll_from_cov(*_t(np.stack([good, C]), np.stack([y, y])))
    assert torch.isfinite(both[0]) and torch.isnan(both[1])


def _direct_inner(L, y):
    """inner by the solve against the identity and one product, written
    out: the route below the edge, bit for bit."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    Cinv = Linv.mT @ Linv
    alpha = (Cinv @ y[..., None])[..., 0]
    return Cinv - alpha[..., :, None] * alpha[..., None, :]


@pytest.mark.parametrize("N,edge,M", [
    (37, 8, 3),     # odd N, uneven halves down to the leaves
    (9, 8, 2),      # edge + 1: one split
    (300, 16, 4),   # well above the edge: four levels
    (257, 16, 1),   # one agent, given without the agent axis
    (40, 40, 4),    # at the edge: the direct route
    (25, 64, 2)])   # below it
def test_inner_from_factor_routes(N, edge, M):
    """inner = C^-1 - alpha alpha^T by the blocked route above `edge`
    (forced here by a small edge) and the direct route at or below it:
    float64 against a dense inverse, exactly symmetric when blocked, bit
    for bit the solve-and-product route when direct, NaN for the agent
    whose factor failed only, each call counted under its route."""
    rng = np.random.default_rng(N + edge)
    G = rng.normal(size=(M, N, N))
    C = torch.from_numpy(G @ G.transpose(0, 2, 1) / N + np.eye(N))
    y = torch.from_numpy(rng.normal(size=(M, N)))
    # numpy's inverse: a batched torch.linalg.inv (MKL getrf) at N = 300
    # under torch.set_num_threads(2) never returns on some CPUs
    Cinv = torch.from_numpy(np.linalg.inv(C.numpy()))
    alpha = Cinv @ y[..., None]
    want = Cinv - alpha * alpha.mT
    blocked = N > edge
    route = default_registry().counter("gp_inner_from_cov_total")
    before = {r: route.value(route=r) for r in ("blocked", "direct")}

    L = cholesky(C)
    if M == 1:
        inner = _inner_from_factor(L[0], y[0], edge)[None]
    else:
        inner = _inner_from_factor(L, y, edge)
    assert inner.shape == want.shape and inner.is_contiguous()
    assert _rel(inner, want) <= 1e-12
    if blocked:
        assert torch.equal(inner, inner.mT)
    else:
        assert torch.equal(inner, _direct_inner(L, y))
    # a failed factor (C not positive definite) in the last agent
    C[-1] = -C[-1]
    inner = _inner_from_factor(cholesky(C), y, edge)
    assert bool(torch.isnan(inner[-1]).all())
    if M > 1:
        assert _rel(inner[:-1], want[:-1]) <= 1e-12
    counts = {r: route.value(route=r) - before[r]
              for r in ("blocked", "direct")}
    assert counts == ({"blocked": 2.0, "direct": 0.0} if blocked
                      else {"blocked": 0.0, "direct": 2.0})


# -- the cached-geometry path and the fused gradient --------------------------

@pytest.mark.parametrize("D", [1, 2, 3])
def test_cache_and_cached_gradient_match_reference(D):
    Xp, yp = _agents(N=37, D=D, seed=10 + D)
    lt = _lt(D, seed=D)
    lts = np.stack([lt, lt + 0.05, lt - 0.05, lt + 0.1])
    cache = build_training_cache(*_t(Xp, yp))
    jd2u = _per_agent(jgp.diff2_stack, Xp)
    d2u, ltt = cache.d2u, torch.from_numpy(lts)
    C, K = cov_from_cache(ltt, d2u)
    jC = np.stack([np.asarray(jtr.cov_from_cache(jnp.asarray(lts[i]),
                                                 jnp.asarray(jd2u[i]))[0])
                   for i in range(4)])
    assert _rel(C, jC) <= 1e-12
    assert _rel(nll_from_cache(ltt, d2u, cache.y),
                _per_agent(jtr.nll_from_cache, lts, jd2u, yp)) <= 1e-12
    want = _per_agent(jtr.nll_grad_cached, lts, jd2u, yp)
    assert _rel(nll_grad_cached(ltt, d2u, cache.y), want) <= 1e-12
    # one agent without the agent axis
    assert _rel(nll_grad_cached(ltt[1], d2u[1], cache.y[1]), want[1]) <= 1e-12


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("bn", [256, 16])
def test_fused_gradient_plain_and_ref_match_reference_f64(D, bn):
    """nll_grad_plain (through ops, with and without K reuse) and the port's
    blocked nll_grad_fused_ref against the reference's oracle."""
    Xp, yp = _agents(N=45, D=D, seed=20 + D)
    lt = _lt(D, seed=D + 4)
    d2u = diff2_stack(torch.from_numpy(Xp))[0]
    C, K = cov_from_cache(torch.from_numpy(lt), d2u)
    inner = inner_from_cov(C, torch.from_numpy(yp[0]))
    want = jref.nll_grad_fused_ref(jnp.asarray(lt), jnp.asarray(d2u.numpy()),
                                   jnp.asarray(inner.numpy()), bn=bn)
    ltt = torch.from_numpy(lt)
    assert _rel(ops.nll_grad_fused(ltt, d2u, inner), want) <= 1e-12
    assert _rel(ops.nll_grad_fused(ltt, d2u, inner, K=K), want) <= 1e-12
    assert _rel(ref.nll_grad_fused_ref(ltt, d2u, inner, bn=bn), want) <= 1e-12
    assert _rel(ref.nll_grad_fused_ref(ltt, d2u, inner, K=K, bn=bn),
                want) <= 1e-12


@pytest.mark.parametrize("D", [1, 2, 3])
def test_plain_f32_matches_pallas_interpret(D):
    """float32 plain version vs the reference's Pallas kernel in interpret
    mode (bn = bm = 32, zero-padded tiles), at the tolerance of
    tests/test_training_fused.py: rtol 1e-3, atol 1e-4 max|ref|."""
    Xp, yp = _agents(N=50, D=D, seed=30 + D)
    lt = _lt(D, seed=D + 7)
    d2u = diff2_stack(torch.from_numpy(Xp))[0]
    C, _ = cov_from_cache(torch.from_numpy(lt), d2u)
    inner = inner_from_cov(C, torch.from_numpy(yp[0]))
    want = np.asarray(jops.nll_grad_fused(
        jnp.asarray(lt), jnp.asarray(d2u.numpy()), jnp.asarray(inner.numpy()),
        use_pallas=True, interpret=True, bn=32, bm=32))
    got = ops.nll_grad_fused(torch.from_numpy(lt).float(), d2u.float(),
                             inner.float())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                               atol=1e-4 * np.abs(want).max())


def test_batched_fused_op_equals_per_agent_calls():
    Xp, yp = _agents(N=30, seed=5)
    lts = torch.from_numpy(np.stack([_lt(2, s) for s in range(4)]))
    d2u = diff2_stack(torch.from_numpy(Xp))
    C, _ = cov_from_cache(lts, d2u)
    inner = inner_from_cov(C, torch.from_numpy(yp))
    out = ops.nll_grad_fused_agents(lts, d2u, inner)
    assert out.shape == (4, 4)
    for m in range(4):
        assert _rel(out[m], ops.nll_grad_fused(lts[m], d2u[m], inner[m])) \
            <= 1e-12


def test_plain_sums_are_the_kernel_contract():
    """nll_grad_plain returns [sum W d2u[d], sum W, tr(inner)] per agent."""
    rng = np.random.default_rng(4)
    d2u = torch.from_numpy(rng.uniform(0, 1, (3, 2, 7, 7)))
    inner = torch.from_numpy(rng.normal(size=(3, 7, 7)))
    params = torch.from_numpy(rng.uniform(0.5, 2, (3, 3)))
    K = params[:, 2, None, None] * torch.exp(
        -(params[:, 0, None, None] * d2u[:, 0]
          + params[:, 1, None, None] * d2u[:, 1]))
    W = inner * K
    want = torch.stack([(W * d2u[:, 0]).sum((1, 2)),
                        (W * d2u[:, 1]).sum((1, 2)), W.sum((1, 2)),
                        torch.diagonal(inner, dim1=1, dim2=2).sum(1)], 1)
    assert _rel(G.nll_grad(d2u, inner, params), want) <= 1e-12


# -- the grad_fn hook ----------------------------------------------------------

def test_make_local_grad_resolutions():
    Xp, yp = _agents(N=30, seed=6)
    Xt, yt = _t(Xp, yp)
    lts = torch.from_numpy(np.stack([LT0] * 4))
    want = _per_agent(jax.grad(jgp.nll), np.stack([LT0] * 4), Xp, yp)
    for grad_fn in (None, "fused"):
        prepare, g = make_local_grad(grad_fn)
        aux = prepare(Xt, yt)
        assert isinstance(aux, TrainingCache) and aux.d2u.shape == \
            (4, 2, 30, 30)
        assert _rel(g(lts, aux), want) <= 1e-9
    prepare, g = make_local_grad("autodiff")
    aux = prepare(Xt, yt)
    assert isinstance(aux, tuple) and _rel(g(lts, aux), want) <= 1e-12
    calls = []

    def custom(lt, Xi, yi):
        calls.append(tuple(Xi.shape))
        return 2.0 * lt
    prepare, g = make_local_grad(custom)
    assert torch.equal(g(lts, prepare(Xt, yt)), 2.0 * lts)
    assert calls == [(30, 2)] * 4                 # once per agent


def test_cache_guard_warns_and_falls_back_like_the_reference():
    Xp, yp = _agents(N=20, seed=7)
    prepare, g = make_local_grad(None, cache_limit_mb=1e-6)
    with pytest.warns(UserWarning) as ours:
        aux = prepare(*_t(Xp, yp))
    jprepare, _ = jtr.make_local_grad(None, cache_limit_mb=1e-6)
    with pytest.warns(UserWarning) as theirs:
        jprepare(jnp.asarray(Xp), jnp.asarray(yp))
    assert str(ours[0].message) == str(theirs[0].message)
    assert "falling back to autodiff" in str(ours[0].message)
    assert not isinstance(aux, TrainingCache)
    lts = torch.from_numpy(np.stack([LT0] * 4))
    assert _rel(g(lts, aux), _per_agent(jax.grad(jgp.nll),
                                        np.stack([LT0] * 4), Xp, yp)) <= 1e-12
    prepare_forced, _ = make_local_grad("fused", cache_limit_mb=1e-6)
    assert isinstance(prepare_forced(*_t(Xp, yp)), TrainingCache)


@pytest.mark.parametrize("free_mb", [1.0, 1e-6])
def test_cache_guard_on_the_card_takes_the_kernel_or_raises(monkeypatch,
                                                             free_mb):
    """Tensors off the CPU never fall back to autodiff: past
    cache_limit_mb the guard's limit is half the card's free memory, and a
    cache past that raises (a meta tensor stands in for a card's)."""
    cache = import_module("repro_torch.core.training.cache")
    monkeypatch.setattr(cache, "_free_mb", lambda device: free_mb)
    Xp, yp = _agents(N=20, seed=7)          # a 0.024 MB cache
    X, y = (t.to("meta") for t in _t(Xp, yp))
    prepare, _ = make_local_grad(None, cache_limit_mb=1e-6)
    if free_mb > 0.1:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            aux = prepare(X, y)
        assert isinstance(aux, TrainingCache)
        assert aux.d2u.shape == (4, 2, 20, 20)
    else:
        with pytest.raises(MemoryError, match="nll_grad kernel only"):
            prepare(X, y)


# -- the trainers ----------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet_data():
    return _agents(N=48, seed=8)


def test_dec_apx_trajectory_matches_reference_100_iterations(fleet_data):
    """The slice's gate: DEC-apx-GP's theta trajectory and residuals over
    100 iterations at the paper's ADMM parameters, 1e-6 in float64."""
    Xp, yp = fleet_data
    th, info = train_dec_apx_gp(*_t(LT0, Xp, yp), path_graph(4), iters=100,
                                diag=True)
    jth, jinfo = jtr.train_dec_apx_gp(jnp.asarray(LT0), jnp.asarray(Xp),
                                      jnp.asarray(yp), jpath_graph(4),
                                      iters=100, diag=True)
    assert th.dtype == torch.float64
    assert _rel(th, jth) <= 1e-6
    jd = jinfo["diagnostics"]
    assert set(info) == set(jinfo) and set(info["diagnostics"]) == set(jd)
    for key in ("theta_trajectory", "residuals", "primal_residuals",
                "dual_residuals", "nll"):
        assert _rel(info["diagnostics"][key], jd[key]) <= 1e-6, key
    assert _rel(info["residuals"], jinfo["residuals"]) <= 1e-6
    plain, pinfo = train_dec_apx_gp(*_t(LT0, Xp, yp), path_graph(4),
                                    iters=100)
    assert set(pinfo) == {"residuals"} and torch.equal(plain, th)


@pytest.mark.parametrize("name", ["dec-c", "c", "apx", "dec-gapx-signature"])
def test_other_admm_trainers_match_reference(fleet_data, name):
    """A few iterations of the other ADMM loops, 1e-9 in float64, with
    their diagnostics."""
    Xp, yp = fleet_data
    lt0, X, y = _t(LT0, Xp, yp)
    jargs = (jnp.asarray(LT0), jnp.asarray(Xp), jnp.asarray(yp))
    if name == "dec-c":
        got = train_dec_c_gp(lt0, X, y, path_graph(4), iters=3,
                             nested_iters=4, diag=True)
        want = jtr.train_dec_c_gp(*jargs, jpath_graph(4), iters=3,
                                  nested_iters=4, diag=True)
    elif name == "c":
        got = train_c_gp(lt0, X, y, iters=3, nested_iters=4, diag=True)
        want = jtr.train_c_gp(*jargs, iters=3, nested_iters=4, diag=True)
    elif name == "apx":
        got = train_apx_gp(lt0, X, y, iters=6, diag=True)
        want = jtr.train_apx_gp(*jargs, iters=6, diag=True)
    else:
        got = train_dec_gapx_gp(lt0, X, y, path_graph(4), iters=4)
        want = jtr.train_dec_gapx_gp(*jargs, jpath_graph(4), iters=4)
    *arrays, info = got
    *jarrays, jinfo = want
    for a, ja in zip(arrays, jarrays):
        assert _rel(a, ja) <= 1e-9
    assert set(info) == set(jinfo)
    for key, val in info.items():
        if key == "diagnostics":
            assert set(val) == set(jinfo[key])
            for k, v in val.items():
                assert _rel(v, jinfo[key][k]) <= 1e-9, k
        else:
            assert _rel(val, jinfo[key]) <= 1e-9, key


def test_fact_gp_matches_reference(fleet_data):
    Xp, yp = fleet_data
    lt, vals = train_fact_gp(*_t(LT0, Xp, yp), steps=5)
    jlt, jvals = jtr.train_fact_gp(jnp.asarray(LT0), jnp.asarray(Xp),
                                   jnp.asarray(yp), steps=5)
    assert _rel(lt, jlt) <= 1e-9 and _rel(vals, jvals) <= 1e-9


@pytest.mark.parametrize("kw", [{}, {"grad_clip": 0.5, "weight_decay": 0.1},
                                {"state_dtype": "float64"}])
def test_adam_matches_reference(kw):
    """Adam's updates with the reference's bias correction, clipping, decay
    and state dtype (float32 by default), over a dict of params."""
    rng = np.random.default_rng(9)
    p = {"a": rng.normal(size=3), "b": rng.normal(size=(2, 2))}
    grads = [{k: rng.normal(size=v.shape) for k, v in p.items()}
             for _ in range(4)]
    tkw = dict(kw, state_dtype=getattr(torch, kw.get("state_dtype",
                                                     "float32")))
    jkw = dict(kw, state_dtype=getattr(jnp, kw.get("state_dtype",
                                                   "float32")))
    opt, jopt = adam(0.05, **tkw), jadam(0.05, **jkw)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    st, jst = opt.init(tp), jopt.init(jp)
    for g in grads:
        upd, st = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             st, tp)
        jupd, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                jst, jp)
        tp, jp = apply_updates(tp, upd), japply(jp, jupd)
    assert int(st["step"]) == int(jst["step"]) == 4
    for k in p:
        assert tp[k].dtype == torch.float64
        tol = 1e-12 if kw.get("state_dtype") == "float64" else 1e-6
        assert _rel(tp[k], jp[k]) <= tol
        assert st["m"][k].dtype == tkw["state_dtype"]


# -- the fleet: train -> factor -> serve ---------------------------------------

def test_fleet_trains_and_serves_like_the_reference(fleet_data):
    """GPFleet(FleetConfig()).fit(Xp, yp) trains with the default dec-apx
    (100 iterations, paper theta0) and serves rBCM: theta to 1e-6, the
    predictions to 1e-9."""
    Xp, yp = fleet_data
    Xs = np.random.default_rng(11).uniform(0, 2, (37, 2))
    cfg = dict(chunk=16, dac_iters=120)
    fleet = GPFleet(FleetConfig(**cfg), device="cpu").fit(Xp, yp)
    jfleet = JGPFleet(JFleetConfig(**cfg)).fit(jnp.asarray(Xp),
                                               jnp.asarray(yp))
    assert fleet.thetas.shape == (4, 4)
    assert _rel(fleet.log_theta, jfleet.log_theta) <= 1e-6
    assert _rel(fleet.thetas, jfleet.thetas) <= 1e-6
    assert _rel(fleet.train_info["residuals"],
                jfleet.train_info["residuals"]) <= 1e-6
    mean, var, _ = fleet.predict(Xs)
    jmean, jvar, _ = jfleet.predict(jnp.asarray(Xs))
    assert _rel(mean, jmean) <= 1e-9 and _rel(var, jvar) <= 1e-9


@pytest.mark.parametrize("trainer", ["fact", "c", "apx", "dec-c"])
def test_fleet_other_trainers_match_reference(fleet_data, trainer):
    Xp, yp = fleet_data
    cfg = dict(trainer=trainer, admm_iters=3, nested_iters=3, fact_steps=4)
    fleet = GPFleet(FleetConfig(**cfg), device="cpu").fit(Xp, yp)
    jfleet = JGPFleet(JFleetConfig(**cfg)).fit(jnp.asarray(Xp),
                                               jnp.asarray(yp))
    assert _rel(fleet.log_theta, jfleet.log_theta) <= 1e-9
    assert _rel(fleet.thetas, jfleet.thetas) <= 1e-9


def test_jax_trained_theta_serves_in_the_port(fleet_data):
    """Train in JAX, serve in the port: the reference's trained log_theta
    and per-agent thetas cross as numpy arrays and the predictions agree."""
    Xp, yp = fleet_data
    Xs = np.random.default_rng(12).uniform(0, 2, (29, 2))
    jfleet = JGPFleet(JFleetConfig(admm_iters=30)).fit(jnp.asarray(Xp),
                                                       jnp.asarray(yp))
    fleet = GPFleet(FleetConfig(), device="cpu").fit(
        Xp, yp, log_theta0=np.asarray(jfleet.log_theta),
        thetas=np.asarray(jfleet.thetas), train=False)
    assert torch.equal(fleet.log_theta,
                       torch.tensor(np.asarray(jfleet.log_theta)))
    assert _rel(fleet.thetas, jfleet.thetas) == 0.0
    mean, var, _ = fleet.predict(Xs)
    jmean, jvar, _ = jfleet.predict(jnp.asarray(Xs))
    assert _rel(mean, jmean) <= 1e-9 and _rel(var, jvar) <= 1e-9


def test_fleet_trains_in_float32_on_the_cpu(fleet_data):
    Xp, yp = (a.astype(np.float32) for a in fleet_data)
    fleet = GPFleet(FleetConfig(admm_iters=20), device="cpu").fit(Xp, yp)
    assert fleet.log_theta.dtype == torch.float32
    assert bool(torch.isfinite(fleet.thetas).all())
