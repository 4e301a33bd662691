"""The yardstick: cost functions against hand counts at tiny shapes, and
the plain reference against float64 closed forms at tiny size."""
import math
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from gpbench import compare, costs, data  # noqa: E402
from gpbench.reference import gp as ref  # noqa: E402

F64 = torch.float64


def test_peaks_are_the_published_ones():
    assert costs.HBM_BYTES_PER_S == 3.35e12
    assert costs.FP32_FLOPS_PER_S == 67e12
    # 16 exp2 a clock per SM against 128 lanes x 2 flops
    assert costs.SFU_EXP_PER_S == pytest.approx(67e12 / 16)


@pytest.mark.parametrize("Nt,M,Ni,D", [(256, 4, 8100, 2), (3, 2, 5, 1)])
def test_rbf_matvec_bound_by_hand(Nt, M, Ni, D):
    pairs = Nt * M * Ni
    by_bytes = 4 * (Nt * D + M * Ni * D + M * Ni + D + 1 + M * Nt) / 3.35e12
    by_ops = max(pairs * (3 * D + 3) / 67e12, pairs / (67e12 / 16))
    ms, kind = costs.rbf_matvec_bound_ms(Nt, M, Ni, D)
    assert ms == pytest.approx(1e3 * max(by_bytes, by_ops))
    assert kind == ("bytes" if by_bytes > by_ops else "operations")


def test_nll_grad_and_cholupdate_bounds_by_hand():
    M, N, D = 2, 3, 1
    ms, kind = costs.nll_grad_bound_ms(M, N, D)
    assert kind == "bytes"
    # inner (2 x 9), the points X (2 x 3 x 1), params (2 x 2), sums (2 x 3)
    assert ms == pytest.approx(1e3 * 4 * (2 * 9 + 2 * 3 + 2 * 2 + 2 * 3)
                               / 3.35e12)
    ms, kind = costs.cholupdate_bound_ms(1, 3, 1)
    # lower triangle of a 3x3 read (6), its lower triangle written (6), x (2)
    assert ms == pytest.approx(1e3 * 4 * (6 + 6 + 2) / 3.35e12)
    assert kind == "bytes"
    # the paper fleet: inner's 1.05 GB dominates, about 0.31 ms
    ms, kind = costs.nll_grad_bound_ms(4, 8100, 2)
    assert kind == "bytes" and ms == pytest.approx(0.3134, rel=1e-3)


def test_unit_work_by_hand():
    # one row, one agent of 2 points in 1-D, chunk 1: kernel row 2*(3+4),
    # mean 2*2, solve 4, |v|^2 2*2; bytes: the factor's 3 entries and the
    # 2 points' (x, alpha), then the row in and (mean, var) out
    flops, bytes_ = costs.serve_row_work(1, 2, 1, 1)
    assert flops == 2 * 7 + 4 + 4 + 4
    assert bytes_ == 4 * (3 + 4) + 4 * 3
    flops, bytes_ = costs.admm_iter_work(1, 2, 1)
    assert flops == 4 * 4 + 8 + 4 * 4 + 4 * 7
    # inner read, the covariance written and read (3 x 4), X (2)
    assert bytes_ == 4 * (3 * 4 + 2)
    flops, bytes_ = costs.observe_round_work(1, 2)
    assert (flops, bytes_) == (5 * 3 + 12, 4 * 5 * 3)
    assert costs.least_s(67e12, 0) == pytest.approx(1.0)
    assert costs.least_s(0, 3.35e12) == pytest.approx(1.0)


def _spd(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    X = torch.rand(n, 2, generator=g, dtype=F64) * 2
    theta = torch.tensor([0.7, 0.4, 1.3, 0.1], dtype=F64)
    C = ref.se(X, X, theta) + 0.01 * torch.eye(n, dtype=F64)
    return X, theta, C, g


@pytest.mark.parametrize("n", [17, 200])
def test_blocked_factor_and_solves_match_float64(n):
    X, theta, C, g = _spd(n)
    L = ref.cholesky(C, "float64")
    torch.testing.assert_close(L, torch.linalg.cholesky(C))
    B = torch.randn(n, 5, generator=g, dtype=F64)
    torch.testing.assert_close(ref.solve_lower(L, B, "float64"),
                               torch.linalg.solve_triangular(L, B,
                                                             upper=False))
    torch.testing.assert_close(ref.solve_upper_t(L, B, "float64"),
                               torch.linalg.solve_triangular(L.T, B,
                                                             upper=True))


def test_kernel_is_the_paper_form():
    x1 = torch.tensor([[0.0, 0.0]], dtype=F64)
    x2 = torch.tensor([[0.6, 0.3]], dtype=F64)
    theta = torch.tensor([1.2, 0.3, 1.3, 0.1], dtype=F64)
    want = 1.3 ** 2 * math.exp(-(0.6 / 1.2) ** 2 - (0.3 / 0.3) ** 2)
    assert float(ref.se(x1, x2, theta)) == pytest.approx(want, rel=1e-14)


def test_rbcm_over_dac_is_the_closed_form():
    """rBCM through 200 DAC sweeps on the 4-path equals the centralized
    rBCM of eq. 14-15 computed in float64 from the same moments."""
    g = torch.Generator().manual_seed(1)
    mu = torch.randn(4, 7, generator=g, dtype=F64)
    var = 0.01 + torch.rand(4, 7, generator=g, dtype=F64)
    pv = 1.69
    A = data.graph({"num_agents": 4, "graph": "path"})
    m, v, res = ref.rbcm(mu, var, pv, A, 200, "float64")
    beta = 0.5 * (math.log(pv) - torch.log(var))
    prec = (beta / var).sum(0) + (1 - beta.sum(0)) / pv
    torch.testing.assert_close(m, (beta * mu / var).sum(0) / prec)
    torch.testing.assert_close(v, 1 / prec)
    # the agents agree to round-off of the largest network sum
    assert res < 1e-12 * compare.sums_scale(m, v)
    assert compare.dac_error(res, m, v, res, m, v) == 0.0


def test_dac_residual_follows_the_perron_powers():
    """The agents' estimates after s sweeps are P^s w0 (Lemma 1's Perron
    matrix of the 4-path, eps = 1/3); their spread falls with s, and with
    no exchange it stays the payloads' own spread."""
    g = torch.Generator().manual_seed(5)
    w0 = torch.randn(4, 6, generator=g, dtype=F64)
    A = data.graph({"num_agents": 4, "graph": "path"})
    L = torch.diag(A.sum(1)) - A
    P = torch.eye(4, dtype=F64) - L / 3
    for s in (1, 7, 30):
        w = ref.dac(w0, A, s, "float64")
        torch.testing.assert_close(w, torch.linalg.matrix_power(P, s) @ w0)
    spreads = [ref.maximin(ref.dac(w0, A, s, "float64")) for s in (0, 10, 50)]
    assert spreads[0] > spreads[1] > spreads[2]
    assert ref.maximin(ref.dac(w0, torch.zeros_like(A), 200, "float64")) \
        == ref.maximin(w0)
    # against a reference that agrees exactly, on answers (0, 1/4): the
    # residual over the largest sum, 4
    mean, var = torch.zeros(3, dtype=F64), torch.full((3,), 0.25, dtype=F64)
    assert compare.dac_error(2.0, mean, var, 0.0, mean, var) == 0.5


def test_local_moments_are_the_posterior():
    X, theta, _, g = _spd(30, seed=2)
    y = torch.randn(30, generator=g, dtype=F64)
    Xs = torch.rand(5, 2, generator=g, dtype=F64)
    L, alpha = ref.factor(X, y, theta, 0.0, "float64")
    mean, var = ref.local_moments(X, L, alpha, theta, Xs, "float64")
    C = ref.se(X, X, theta) + theta[3] ** 2 * torch.eye(30, dtype=F64)
    ks = ref.se(X, Xs, theta)
    torch.testing.assert_close(mean, ks.T @ torch.linalg.solve(C, y))
    torch.testing.assert_close(
        var, theta[2] ** 2 - (ks * torch.linalg.solve(C, ks)).sum(0))


def test_nll_grad_is_the_gradient_of_the_nll():
    X, _, _, g = _spd(40, seed=3)
    y = torch.randn(40, generator=g, dtype=F64)
    lt = torch.log(torch.tensor([0.7, 0.4, 1.3, 0.2], dtype=F64))

    def nll(lt):
        th = torch.exp(lt)
        C = ref.se(X, X, th) + th[3] ** 2 * torch.eye(40, dtype=F64)
        return 0.5 * (y @ torch.linalg.solve(C, y) + torch.logdet(C))
    want = torch.func.grad(nll)(lt)
    torch.testing.assert_close(ref.nll_grad(X, y, lt, 0.0, "float64"), want)


def test_dec_apx_first_step_is_eq_34():
    g = torch.Generator().manual_seed(4)
    Xp = torch.rand(3, 12, 2, generator=g, dtype=F64)
    yp = torch.randn(3, 12, generator=g, dtype=F64)
    lt0 = torch.log(torch.tensor([2.0, 0.5, 1.0, 1.0], dtype=F64))
    A = data.graph({"num_agents": 3, "graph": "path"})
    th, res = ref.dec_apx(Xp, yp, lt0, A, 500.0, 1e4, 1, 0.0, "float64")
    deg = A.sum(1)[:, None]
    grads = torch.stack([ref.nll_grad(Xp[i], yp[i], lt0, 0.0, "float64")
                         for i in range(3)])
    # equal thetas: the neighbour sum is deg * theta and the dual stays 0
    want = (500 * deg * lt0 - grads + (1e4 + 500 * deg) * lt0) \
        / (1e4 + 1000 * deg)
    torch.testing.assert_close(th, want)
    assert float(res[0]) == pytest.approx(
        float((want - want.mean(0)).abs().max()))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -12,
                      -3.0 - 2 ** -12], dtype=torch.float32)
    torch.testing.assert_close(
        ref.tf32(x), torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -10,
                                   -3.0], dtype=torch.float32))


def test_window_keeps_the_newest_points():
    X0 = torch.arange(8, dtype=F64).reshape(4, 2)
    xs = 10 + torch.arange(4, dtype=F64).reshape(2, 2)
    X, y = ref.window(X0, torch.arange(4.0), xs, torch.tensor([9.0, 10.0]),
                      4)
    torch.testing.assert_close(X, torch.cat([X0[2:], xs]))
    torch.testing.assert_close(y, torch.tensor([2.0, 3.0, 9.0, 10.0]))


def test_theta_gaps_of_an_unchanged_fit_read_one():
    lt0 = torch.zeros(2, 3, dtype=F64)
    ref_th = torch.ones(2, 3, dtype=F64)
    res = torch.tensor([0.5, 0.2], dtype=F64)
    gaps = compare.theta_gaps(lt0, torch.zeros(2), ref_th, res, lt0[0])
    assert gaps["change_gap"] == 1.0 and gaps["first_residual_gap"] == 1.0
