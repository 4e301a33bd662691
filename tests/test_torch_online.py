"""The port's streaming subsystem (repro_torch.core.online, the cholupdate
op, the engine's swap_experts/rewire) against the JAX package on the CPU,
in float64, to 1e-9 relative to the largest reference entry (same
algorithms, different LAPACK/BLAS rounding), and against a numpy
refactorization.

The reference's rank-1 update is checked through its jnp path
(`ops.cholupdate` off the TPU, which is `ref.cholupdate_ref`): its Pallas
path does not build on jax 0.9.0 (ROADMAP C1). Inputs are drawn with
numpy from a seed, at W <= 64 and M <= 4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import online as J
from repro.core.consensus import attach_agent as j_attach
from repro.core.consensus import path_graph as j_path
from repro.core.consensus import remove_agent as j_remove
from repro.core.prediction import PredictionEngine as JEngine
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import online as T
from repro_torch.core.consensus import (attach_agent, is_connected,
                                        path_graph, remove_agent)
from repro_torch.core.prediction import PredictionEngine
from repro_torch.kernels import ops, ref
from repro_torch.kernels import cholupdate as C

torch.set_num_threads(2)

# the reference's streaming calls, compiled once for the whole file
J_OBSERVE = jax.jit(J.observe)
J_OBSERVE_FLEET = jax.jit(J.observe_fleet)
J_EVICT = jax.jit(J.evict_oldest)

TOL = 1e-9
LOG_THETA = np.log([1.2, 0.3, 1.3, 0.1])
M, W, D = 4, 12, 2


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def _spd_factor(n, seed):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n))
    A = B @ B.T + n * np.eye(n)
    return A, np.linalg.cholesky(A), rng.standard_normal(n)


# -- the rank-1 update -------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 37, 130])
@pytest.mark.parametrize("mode", ["update", "downdate", "shift"])
def test_cholupdate_matches_reference_and_refactorization(n, mode):
    A, L, x = _spd_factor(n, n)
    if mode == "downdate":
        A = A + np.outer(x, x)
        L = np.linalg.cholesky(A)
    if mode == "shift":
        x = L[:, 0]
    kw = dict(downdate=mode == "downdate", shift=int(mode == "shift"))
    got = ops.cholupdate(torch.tensor(L), torch.tensor(x), **kw)
    want = jops.cholupdate(jnp.asarray(L), jnp.asarray(x), **kw)
    assert got.dtype == torch.float64
    _close(got, want)
    if mode == "shift":
        if n > 1:
            _close(got[:n - 1, :n - 1], np.linalg.cholesky(A[1:, 1:]))
        _close(got[n - 1], L[n - 1], 0)          # the stale last row
    else:
        sign = -1.0 if kw["downdate"] else 1.0
        _close(got, np.linalg.cholesky(A + sign * np.outer(x, x)))
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))


@pytest.mark.parametrize("n,bk", [(37, 16), (130, 32), (64, 64)])
@pytest.mark.parametrize("shift", [0, 1, 3])
def test_blocked_ref_matches_reference_ref(n, bk, shift):
    _, L, x = _spd_factor(n, 7 * n + shift)
    for downdate, xv in ((False, x), (True, 0.1 * x)):
        got = ref.cholupdate_ref(torch.tensor(L), torch.tensor(xv),
                                 downdate, bk, shift)
        want = jref.cholupdate_ref(jnp.asarray(L), jnp.asarray(xv),
                                   downdate, bk, shift)
        _close(got, want, 1e-12)
        _close(C.cholupdate_plain(torch.tensor(L)[None],
                                  torch.tensor(xv)[None], downdate,
                                  shift)[0], want)


@pytest.mark.parametrize("shift", [0, 1])
def test_zero_x_is_a_bitwise_noop(shift):
    _, L, _ = _spd_factor(24, 1)
    Lt = torch.tensor(L)
    out = ops.cholupdate(Lt, torch.zeros(24))
    np.testing.assert_allclose(out.numpy(), L, atol=0)
    assert torch.equal(out, Lt)
    # a zero head (a window's sentinel-free prefix evicts from a vector
    # that is zero below `count`) leaves the leading columns bitwise alone
    x = torch.zeros(24, dtype=torch.float64)
    x[16:] = 0.3
    part = ops.cholupdate(Lt, x, shift=shift)
    assert torch.equal(part[:16 - shift, :16 - shift],
                       Lt[shift:16, shift:16])


def test_masked_fleet_matches_per_agent_reference():
    """cholupdate_fleet with an agent mask against the reference's vmapped
    `lax.cond(full, evict, id)`: inactive agents come back unchanged."""
    Ls = np.stack([_spd_factor(20, s)[1] for s in range(4)])
    xs = Ls[:, :, 0]
    active = np.array([True, False, True, False])
    got = ops.cholupdate_fleet(torch.tensor(Ls), torch.tensor(xs), shift=1,
                               active=torch.tensor(active))

    def one(L, x, a):
        return jax.lax.cond(a, lambda: jops.cholupdate(L, x, shift=1),
                            lambda: L)
    want = jax.vmap(one)(jnp.asarray(Ls), jnp.asarray(xs),
                         jnp.asarray(active))
    _close(got, want)
    assert torch.equal(got[~torch.tensor(active)],
                       torch.tensor(Ls)[~torch.tensor(active)])


# -- sliding-window experts -------------------------------------------------

def _pair_init(Mn=M, Wn=W):
    js = J.init_online(jnp.asarray(LOG_THETA), Mn, Wn, D,
                       dtype=jnp.float64)
    ts = T.init_online(torch.tensor(LOG_THETA), Mn, Wn, D,
                       dtype=torch.float64)
    return js, ts


def _assert_state_close(ts, js, tol=TOL):
    for name in ("Xw", "yw", "L", "alpha"):
        _close(getattr(ts, name), getattr(js, name), tol)
    assert np.array_equal(ts.count.numpy(), np.asarray(js.count))
    assert ts.count.dtype == torch.int32


def test_init_online_and_from_batch_match_reference():
    js, ts = _pair_init()
    _assert_state_close(ts, js)
    rng = np.random.default_rng(0)
    Xp, yp = rng.uniform(0, 2, (M, 20, D)), rng.standard_normal((M, 20))
    for window in (None, 12):
        jb = J.from_batch(jnp.asarray(LOG_THETA), jnp.asarray(Xp),
                          jnp.asarray(yp), window=window)
        tb = T.from_batch(torch.tensor(LOG_THETA), torch.tensor(Xp),
                          torch.tensor(yp), window=window)
        _assert_state_close(tb, jb)


@pytest.mark.parametrize("seed", [0, 1])
def test_randomized_observe_evict_matches_reference_and_refit(seed):
    js, ts = _pair_init()
    rng = np.random.default_rng(seed)
    for _ in range(60):
        a = int(rng.integers(0, M))
        if rng.random() < 0.25:
            js, ts = J_EVICT(js, a), T.evict_oldest(ts, a)
        else:
            x, y = rng.standard_normal(D), rng.standard_normal()
            js = J_OBSERVE(js, a, jnp.asarray(x), jnp.asarray(y))
            ts = T.observe(ts, a, torch.tensor(x), y)
    _assert_state_close(ts, js)
    r = T.refit(ts)
    _close(ts.L, r.L, 1e-9)
    _close(ts.alpha, r.alpha, 1e-8)


def test_observe_fleet_with_mixed_windows_matches_reference():
    """Full and non-full windows in one fleet-wide round: the full ones
    evict through the masked rank-1 update, the others only append."""
    js, ts = _pair_init()
    rng = np.random.default_rng(5)
    for a, k in ((0, W), (1, 5), (2, W)):            # counts [12, 5, 12, 0]
        for _ in range(k):
            x, y = rng.standard_normal(D), rng.standard_normal()
            js = J_OBSERVE(js, a, jnp.asarray(x), jnp.asarray(y))
            ts = T.observe(ts, a, torch.tensor(x), y)
    assert ts.count.tolist() == [W, 5, W, 0]
    for _ in range(W + 3):                           # wrap every window
        xs, ys = rng.standard_normal((M, D)), rng.standard_normal(M)
        js = J_OBSERVE_FLEET(js, jnp.asarray(xs), jnp.asarray(ys))
        ts = T.observe_fleet(ts, xs, ys)
        _assert_state_close(ts, js)
    assert ts.count.tolist() == [W] * M
    r = T.refit(ts)
    _close(ts.L, r.L)
    _close(ts.alpha, r.alpha, 1e-8)


def test_updates_leave_their_input_state_alone():
    _, ts = _pair_init()
    ts = T.observe_fleet(ts, np.ones((M, D)), np.ones(M))
    before = [t.clone() for t in ts]
    T.observe_fleet(ts, np.zeros((M, D)), np.zeros(M))
    T.observe(ts, 1, np.zeros(D), 0.0)
    T.evict_oldest(ts, 2)
    assert all(torch.equal(a, b) for a, b in zip(ts, before))


def test_evict_on_an_empty_window_is_a_noop():
    js, ts = _pair_init()
    ts2 = T.evict_oldest(ts, 0)
    _assert_state_close(ts2, J_EVICT(js, 0))
    assert all(torch.equal(a, b) for a, b in zip(ts, ts2))


def test_from_numpy_carries_a_jax_state_across():
    rng = np.random.default_rng(2)
    js = J.from_batch(jnp.asarray(LOG_THETA),
                      jnp.asarray(rng.uniform(0, 2, (M, 10, D))),
                      jnp.asarray(rng.standard_normal((M, 10))), window=W)
    ts = T.OnlineExperts.from_numpy(
        {k: np.asarray(v) for k, v in js._asdict().items()}, device="cpu")
    _assert_state_close(ts, js, 0)             # carried bit for bit
    for _ in range(4):
        xs, ys = rng.standard_normal((M, D)), rng.standard_normal(M)
        js = J_OBSERVE_FLEET(js, jnp.asarray(xs), jnp.asarray(ys))
        ts = T.observe_fleet(ts, xs, ys)
    _assert_state_close(ts, js)
    assert ts.window == W and ts.num_agents == M
    assert ts.valid.tolist() == np.asarray(js.valid).tolist()


# -- membership --------------------------------------------------------------

@pytest.mark.parametrize("neighbors", [None, (0, 2)])
def test_attach_and_remove_agent_match_reference(neighbors):
    A = path_graph(4)
    nb = (3,) if neighbors is None else neighbors
    _close(attach_agent(A, nb), j_attach(j_path(4), nb), 0)
    for i in range(4):
        got = remove_agent(A, i)
        _close(got, j_remove(j_path(4), i), 0)
        assert is_connected(got)
    with pytest.raises(ValueError, match="at least one neighbor"):
        attach_agent(A, [])
    with pytest.raises(ValueError, match="out of range"):
        attach_agent(A, [7])


def test_join_and_leave_match_reference():
    rng = np.random.default_rng(4)
    js, ts = _pair_init()
    for _ in range(3):
        xs, ys = rng.standard_normal((M, D)), rng.standard_normal(M)
        js = J_OBSERVE_FLEET(js, jnp.asarray(xs), jnp.asarray(ys))
        ts = T.observe_fleet(ts, xs, ys)
    Xn, yn = rng.uniform(0, 2, (20, D)), rng.standard_normal(20)
    js2, jA = J.join(js, j_path(M), jnp.asarray(Xn), jnp.asarray(yn))
    ts2, tA = T.join(ts, path_graph(M), Xn, yn)
    _assert_state_close(ts2, js2)
    _close(tA, jA, 0)
    js3, jA3 = J.join(js, j_path(M))                 # joins empty
    ts3, tA3 = T.join(ts, path_graph(M))
    _assert_state_close(ts3, js3)
    js4, jA4 = J.leave(js2, jA, 1)
    ts4, tA4 = T.leave(ts2, tA, 1)
    _assert_state_close(ts4, js4)
    _close(tA4, jA4, 0)
    with pytest.raises(ValueError, match="not in fleet"):
        T.leave(ts, path_graph(M), M)
    one = T.init_online(torch.tensor(LOG_THETA), 1, W, D)
    with pytest.raises(ValueError, match="last agent"):
        T.leave(one, path_graph(1), 0)


# -- serving the live fleet --------------------------------------------------

@pytest.mark.parametrize("method", ["rbcm", "poe"])
def test_swap_and_rewire_serve_like_the_reference(method):
    rng = np.random.default_rng(6)
    js, ts = _pair_init()
    Xq = rng.uniform(0, 2, (13, D))
    kw = dict(chunk=8, dac_iters=120)
    jeng = JEngine(js.to_fitted(), j_path(M), **kw)
    teng = PredictionEngine(ts.to_fitted(), path_graph(M), device="cpu",
                            **kw)
    A_before = teng.A
    for _ in range(W + 2):
        xs, ys = rng.uniform(0, 2, (M, D)), rng.standard_normal(M)
        js = J_OBSERVE_FLEET(js, jnp.asarray(xs), jnp.asarray(ys))
        ts = T.observe_fleet(ts, xs, ys)
    jeng.swap_experts(js.to_fitted())
    teng.swap_experts(ts.to_fitted())
    assert teng.A is A_before and teng.fitted.L is ts.L
    for got, want in zip(teng.predict(method, Xq)[:2],
                         jeng.predict(method, jnp.asarray(Xq))[:2]):
        _close(got, want)
    Xn, yn = rng.uniform(0, 2, (W, D)), rng.standard_normal(W)
    js2, jA = J.join(js, jeng.A, jnp.asarray(Xn), jnp.asarray(yn))
    ts2, tA = T.join(ts, teng.A, Xn, yn)
    with pytest.raises(ValueError, match="rewire"):
        teng.swap_experts(ts2.to_fitted())
    with pytest.raises(ValueError, match="adjacency"):
        teng.rewire(path_graph(M), fitted=ts2.to_fitted())
    jeng.rewire(jA, fitted=js2.to_fitted())
    teng.rewire(tA, fitted=ts2.to_fitted())
    assert teng.A.shape == (M + 1, M + 1) and teng.A.dtype == torch.float64
    for got, want in zip(teng.predict(method, Xq)[:2],
                         jeng.predict(method, jnp.asarray(Xq))[:2]):
        _close(got, want)
