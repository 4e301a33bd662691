"""Parity of the port's consensus protocols (repro_torch.core.consensus:
jor, dale, power_method, flooding and graph.diameter) with the JAX
package, on the same float64 numpy inputs.

Tolerance 1e-12 relative to max|reference|: the port folds JOR's affine
update into one product (q' = c + G q) and DALE's into a neighbour average
and a projection, so each iteration rounds differently from the
reference's, by a few ulps; the iterations contract, so those differences
do not grow.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.consensus import dale as jdale
from repro.core.consensus import diameter as jdiameter
from repro.core.consensus import extreme_eigs as jextreme_eigs
from repro.core.consensus import flood as jflood
from repro.core.consensus import jor as jjor
from repro.core.consensus import optimal_omega as joptimal_omega
from repro.core.consensus import power_method as jpower_method
from repro_torch.core.consensus import (complete_graph, cycle_graph, dale,
                                        diameter, extreme_eigs, flood, jor,
                                        optimal_omega, path_graph,
                                        power_method, random_connected_graph)

torch.set_num_threads(2)

TOL = 1e-12
M = 4


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def _spd(seed, m=M):
    """A symmetric positive definite system like an NPAE C_A (diagonally
    dominant enough for JOR at omega < 2/M)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(m, m))
    return X @ X.T + m * np.eye(m), rng


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rhs", ["1d", "2d"])
def test_jor_matches_reference(masked, rhs):
    H, rng = _spd(1)
    b = rng.normal(size=(M,) if rhs == "1d" else (M, 2))
    mask = np.array([1.0, 0.0, 1.0, 1.0]) if masked else None
    kw = {} if mask is None else {"mask": mask}
    q, res = jor(torch.tensor(H), torch.tensor(b), 0.45, 60,
                 **{k: torch.tensor(v) for k, v in kw.items()})
    qj, resj = jjor(jnp.asarray(H), jnp.asarray(b), 0.45, 60,
                    **{k: jnp.asarray(v) for k, v in kw.items()})
    _close(q, qj)
    _close(res, resj)
    if masked:
        assert float(q[1].abs().max()) == 0.0      # dead entry settles at 0


def test_jor_q0_and_batched_omega_match_reference():
    """A start q0, and a batch of systems with one omega each (DEC-NPAE*'s
    per-query relaxation) against the reference vmapped."""
    Hs, bs, q0s = [], [], []
    for seed in range(3):
        H, rng = _spd(10 + seed)
        Hs.append(H)
        bs.append(rng.normal(size=(M, 2)))
        q0s.append(rng.normal(size=(M, 2)))
    Hs, bs, q0s = np.stack(Hs), np.stack(bs), np.stack(q0s)
    oms = np.array([0.3, 0.45, 0.49])
    q, res = jor(torch.tensor(Hs), torch.tensor(bs), torch.tensor(oms), 40,
                 q0=torch.tensor(q0s))
    assert q.shape == (3, M, 2) and res.shape == (3, 40)
    for t in range(3):
        qj, resj = jjor(jnp.asarray(Hs[t]), jnp.asarray(bs[t]), oms[t], 40,
                        q0=jnp.asarray(q0s[t]))
        _close(q[t], qj)
        _close(res[t], resj)


@pytest.mark.parametrize("graph", ["path", "cycle", "complete"])
def test_dale_matches_reference(graph):
    A = {"path": path_graph, "cycle": cycle_graph,
         "complete": complete_graph}[graph](M)
    H, rng = _spd(2)
    b = rng.normal(size=M)
    Q, res = dale(torch.tensor(H), torch.tensor(b), A, 300)
    Qj, resj = jdale(jnp.asarray(H), jnp.asarray(b), jnp.asarray(A.numpy()),
                     300)
    _close(Q, Qj)
    _close(res, resj)


def test_dale_stacked_rhs_and_batch_equal_separate_calls():
    """DEC-NN-NPAE stacks the mean and k right-hand sides and every query
    of a tile: each column of each system is the reference's own call."""
    A = path_graph(M)
    Hs = np.stack([_spd(20 + t)[0] for t in range(3)])
    bs = np.random.default_rng(5).normal(size=(3, M, 2))
    Q, res = dale(torch.tensor(Hs), torch.tensor(bs), A, 200)
    assert Q.shape == (3, M, M, 2) and res.shape == (3, 200)
    for t in range(3):
        rk = []
        for k in range(2):
            Qj, resj = jdale(jnp.asarray(Hs[t]), jnp.asarray(bs[t, :, k]),
                             jnp.asarray(A.numpy()), 200)
            _close(Q[t, ..., k], Qj)
            rk.append(np.asarray(resj))
        _close(res[t], np.maximum(*rk))


def test_dale_degree_zero_agent_keeps_its_local_solution():
    """An agent with no neighbour stays at its local solution instead of
    0/0 = NaN (the reference's max(deg, 1) guard)."""
    A = path_graph(M).numpy().copy()
    A[3, :] = A[:, 3] = 0.0                       # agent 3 severed
    H, rng = _spd(3)
    b = rng.normal(size=M)
    Q, res = dale(torch.tensor(H), torch.tensor(b), torch.tensor(A), 50)
    Qj, resj = jdale(jnp.asarray(H), jnp.asarray(b), jnp.asarray(A), 50)
    assert bool(torch.isfinite(Q).all())
    _close(Q, Qj)
    _close(res, resj)
    x3 = H[3] * b[3] / (H[3] @ H[3])
    _close(Q[3], x3)


def test_power_method_and_extreme_eigs_match_reference():
    H, _ = _spd(4)
    R = H / np.diag(H)[:, None]
    lam, traj = power_method(torch.tensor(R), 80)
    lamj, trajj = jpower_method(jnp.asarray(R), 80)
    _close(lam, lamj)
    _close(traj, trajj)
    lmax, lmin = extreme_eigs(torch.tensor(R), 80)
    lmaxj, lminj = jextreme_eigs(jnp.asarray(R), 80)
    _close(lmax, lmaxj)
    _close(lmin, lminj)


@pytest.mark.parametrize("R", [np.zeros((1, 1)), np.zeros((3, 3)),
                               np.eye(3)])
def test_power_method_zero_iterate_reports_zero(R):
    """A zero iterate (the shifted B of a 1x1 or identity R) reports
    lambda = 0, not NaN, as the reference's guard does."""
    lam, traj = power_method(torch.tensor(R), 10)
    lamj, trajj = jpower_method(jnp.asarray(R), 10)
    assert bool(torch.isfinite(traj).all())
    _close(lam, lamj, 0)
    _close(traj, trajj, 0)
    if not R.any():
        assert float(lam) == 0.0
    _close(optimal_omega(torch.tensor(np.eye(3)), 10),
           joptimal_omega(jnp.asarray(np.eye(3)), 10))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_optimal_omega_matches_reference(seed):
    H, _ = _spd(30 + seed, m=6)
    _close(optimal_omega(torch.tensor(H), 100),
           joptimal_omega(jnp.asarray(H), 100))


def test_optimal_omega_batched_equals_per_system():
    Hs = np.stack([_spd(40 + t)[0] for t in range(4)])
    om = optimal_omega(torch.tensor(Hs), 60)
    assert om.shape == (4,)
    for t in range(4):
        _close(om[t], joptimal_omega(jnp.asarray(Hs[t]), 60))


@pytest.mark.parametrize("A", [path_graph(5), cycle_graph(6),
                               complete_graph(4),
                               random_connected_graph(7, 0.3, seed=2)],
                         ids=["path", "cycle", "complete", "random"])
def test_diameter_and_flood_match_reference(A):
    An = A.numpy()
    assert diameter(A) == jdiameter(jnp.asarray(An))
    vals = torch.arange(An.shape[0] * 2.0).reshape(-1, 2)
    got, rounds = flood(vals, A)
    _, roundsj = jflood(jnp.asarray(vals.numpy()), jnp.asarray(An))
    assert got is vals and rounds == roundsj


def test_diameter_of_a_disconnected_graph_is_inf():
    A = np.zeros((4, 4))
    A[0, 1] = A[1, 0] = A[2, 3] = A[3, 2] = 1.0
    assert diameter(torch.tensor(A)) == float("inf") \
        == jdiameter(jnp.asarray(A))
    assert diameter(torch.zeros(1, 1)) == 0.0
