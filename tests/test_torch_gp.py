"""Parity of the port's GP core, data and consensus modules (repro_torch)
with the JAX package on the same numpy inputs.

Deterministic float64 functions are held to the reference at 1e-12: both
packages evaluate the same formulas in the same order, so only summation
order inside BLAS can differ (~1e-15). The samplers draw from different
generators, so `gp_sample_field` is held to its distribution.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consensus as jcons
from repro.core.gp import kernel as jkernel
from repro.core.gp import partition as jpart
from repro.data import grid_inputs as jgrid_inputs
from repro_torch.core import consensus as tcons
from repro_torch.core.gp import cov_matrix, pack, se_kernel, sq_dists, \
    stripe_partition, unpack
from repro_torch.data import (gp_sample_field, grid_inputs, random_inputs,
                              rff_field)

torch.set_num_threads(2)

TOL = 1e-12          # float64, same formulas: only BLAS summation order
LOG_THETA = np.log([1.2, 0.3, 1.3, 0.1])


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= tol * scale


@pytest.fixture(scope="module")
def pts():
    rng = np.random.default_rng(0)
    return rng.uniform(0, 2, (37, 2)), rng.uniform(0, 2, (23, 2))


def test_unpack_pack_match_reference():
    lt = pack([1.2, 0.3], 1.3, 0.1, dtype=torch.float64)
    _close(lt, jkernel.pack([1.2, 0.3], 1.3, 0.1))
    for got, want in zip(unpack(lt), jkernel.unpack(jnp.asarray(LOG_THETA))):
        _close(got, want)


def test_sq_dists_matches_reference(pts):
    x1, x2 = pts
    ls = np.array([1.2, 0.3])
    _close(sq_dists(_t(x1), _t(x2), _t(ls)),
           jkernel.sq_dists(jnp.asarray(x1), jnp.asarray(x2),
                            jnp.asarray(ls)))


def test_se_kernel_and_cov_matrix_match_reference(pts):
    x1, x2 = pts
    lt = _t(LOG_THETA)
    _close(se_kernel(_t(x1), _t(x2), lt),
           jkernel.se_kernel(jnp.asarray(x1), jnp.asarray(x2),
                             jnp.asarray(LOG_THETA)))
    _close(cov_matrix(_t(x1), lt, 1e-8),
           jkernel.cov_matrix(jnp.asarray(x1), jnp.asarray(LOG_THETA), 1e-8))


def test_se_kernel_batches_over_agents(pts):
    """The agent axis written out equals one call per agent."""
    x1, x2 = pts
    Xp = _t(np.stack([x1[:20], x1[17:]]))
    lt = _t(LOG_THETA)
    batched = se_kernel(Xp, _t(x2)[None], lt)
    for m in range(2):
        _close(batched[m], se_kernel(Xp[m], _t(x2), lt))


@pytest.mark.parametrize("N,M", [(60, 4), (61, 4)])
def test_stripe_partition_matches_reference(N, M):
    rng = np.random.default_rng(N)
    X, y = rng.uniform(0, 2, (N, 2)), rng.normal(size=N)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        Xp, yp = stripe_partition(_t(X), _t(y), M)
        jXp, jyp = jpart.stripe_partition(jnp.asarray(X), jnp.asarray(y), M)
    _close(Xp, jXp)
    _close(yp, jyp)
    dropped = [w for w in caught if issubclass(w.category, UserWarning)
               and "dropping" in str(w.message)]
    assert len(dropped) == (2 if N % M else 0)      # both packages warn


@pytest.mark.parametrize("name", ["path", "cycle", "complete", "random"])
@pytest.mark.parametrize("M", [2, 5])
def test_graph_builders_match_reference(name, M):
    if name == "random":
        got = tcons.random_connected_graph(M, 0.4, seed=3)
        want = jcons.random_connected_graph(M, 0.4, seed=3)
    else:
        got = getattr(tcons, f"{name}_graph")(M)
        want = getattr(jcons, f"{name}_graph")(M)
    _close(got, want)
    _close(tcons.perron(got, 0.2), jcons.perron(want, 0.2))
    assert float(tcons.max_degree(got)) == float(jcons.max_degree(want))
    assert tcons.is_connected(got) == jcons.is_connected(want)


def test_connected_components_match_reference():
    A = np.asarray(jcons.path_graph(6))
    alive = np.array([1, 1, 0, 1, 1, 1])
    np.testing.assert_array_equal(
        tcons.connected_components(_t(A), alive=alive),
        jcons.connected_components(jnp.asarray(A), alive=alive))
    assert not tcons.is_connected(_t(np.zeros((3, 3))))


@pytest.mark.parametrize("shape", [(5,), (5, 7)])
@pytest.mark.parametrize("eps", [None, 0.3])
def test_dac_trajectory_matches_reference(shape, eps):
    """Final state and the whole residual trajectory of the lax.scan."""
    rng = np.random.default_rng(1)
    w0 = rng.normal(size=shape)
    A = np.asarray(jcons.random_connected_graph(5, 0.3, seed=1))
    w, res = tcons.dac(_t(w0), _t(A), 40, eps=eps)
    jw, jres = jcons.dac(jnp.asarray(w0), jnp.asarray(A), 40, eps=eps)
    _close(w, jw)
    assert res.shape == (40,)
    _close(res, jres)
    _close(tcons.dac_residual(w), jcons.dac_residual(jw), 1e-9)


def test_dac_until_matches_reference():
    rng = np.random.default_rng(2)
    w0 = rng.normal(size=(4, 3))
    A = np.asarray(jcons.path_graph(4))
    w, it = tcons.dac_until(_t(w0), _t(A), tol=1e-10, chunk=16)
    jw, jit = jcons.dac_until(jnp.asarray(w0), jnp.asarray(A), tol=1e-10,
                              chunk=16)
    assert it == jit
    _close(w, jw)


def test_random_and_grid_inputs():
    g = torch.Generator().manual_seed(0)
    X = random_inputs(g, 500, D=3, lo=-1.0, hi=2.0)
    assert X.shape == (500, 3) and X.dtype == torch.float64
    assert float(X.min()) >= -1.0 and float(X.max()) < 2.0
    G = grid_inputs(4)
    _close(G, jgrid_inputs(4))


@pytest.mark.parametrize("exact_max_n", [4096, 0])
def test_gp_sample_field_covariance(exact_max_n):
    """Empirical covariance of many draws against se_kernel, for the exact
    branch and the RFF branch (exact_max_n=0 forces it). With 3000 draws
    an entry of the sample covariance has standard error about
    sigma_f^2 * sqrt(2/3000) = 0.044; 0.2 is over four of them. The noise
    y - f must have standard deviation sigma_eps."""
    X = _t(np.array([[0.1, 0.2], [0.5, 0.3], [1.0, 1.0], [0.12, 0.9]]))
    lt = _t(LOG_THETA)
    g = torch.Generator().manual_seed(7)
    draws = [gp_sample_field(g, X, lt, exact_max_n=exact_max_n,
                             rff_features=2048) for _ in range(3000)]
    F = torch.stack([f for f, _ in draws])
    noise = torch.stack([y - f for f, y in draws])
    emp = (F.T @ F) / F.shape[0]
    assert float((emp - se_kernel(X, X, lt)).abs().max()) < 0.2
    assert abs(float(noise.std()) - 0.1) < 0.005
    assert abs(float(F.mean())) < 0.1


def test_gp_sample_field_float32_exact_branch_finite():
    """The float32 nugget keeps the Cholesky of near-duplicate inputs
    finite, as in the reference."""
    g = torch.Generator().manual_seed(0)
    X = random_inputs(g, 300, dtype=torch.float32)
    f, y = gp_sample_field(g, X, _t(LOG_THETA).float())
    assert bool(torch.isfinite(f).all()) and bool(torch.isfinite(y).all())


def test_rff_field_is_gp_sample_fields_large_draw():
    """Above exact_max_n gp_sample_field draws its field through rff_field:
    the same generator state gives the same field, and the returned
    function evaluates it at more points."""
    lt = _t(LOG_THETA).float()
    g = torch.Generator().manual_seed(5)
    X = random_inputs(g, 300, dtype=torch.float32)
    f, y = gp_sample_field(g, X, lt, exact_max_n=100, rff_features=64)
    g = torch.Generator().manual_seed(5)
    X2 = random_inputs(g, 300, dtype=torch.float32)
    field = rff_field(g, lt, 2, rff_features=64, dtype=torch.float32)
    assert torch.equal(field(X2), f)
    noise = torch.exp(lt[-1]) * torch.randn(300, generator=g)
    assert torch.equal(f + noise, y)
    assert field(X2[:7]).shape == (7,)
