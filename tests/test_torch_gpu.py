"""The port on a CUDA card: the hand-written rbf_matvec, nll_grad,
cholupdate, rbf_gram and flash_attention kernels against their plain
versions, their dispatch, the serving path with and without rbf_matvec,
degraded (fault-plan) serving and the serving scheduler on the card,
training through nll_grad, the streaming fleet through cholupdate, the
sparse fleet's fit through rbf_gram, LM serving through
flash_attention, LM training through its log-sum-exp output and the
ported backward (FlashAttentionFunction), the xLSTM's chunked mLSTM
against its sequential form, and a prefill placed on a (1, 1) mesh.

Every test here is marked `gpu` and skips (in its fixture) without a card.
This file imports no JAX, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
from importlib import import_module

import numpy as np
import pytest
import torch

from repro_torch.chaos import Dropout, FaultPlan
from repro_torch.core.consensus import path_graph
from repro_torch.core.gp import cov_matrix, diff2_stack, inner_from_cov, pack
from repro_torch.core.online import refit
from repro_torch.core.prediction import PredictionEngine
from repro_torch.core.training import cov_from_cache, train_dec_apx_gp
from repro_torch.fleet import FleetConfig, GPFleet
from repro_torch.kernels import cholupdate as C
from repro_torch.kernels import flash_attention as F
from repro_torch.kernels import nll_grad as G
from repro_torch.kernels import rbf_gram as RG
from repro_torch.kernels import ops
from repro_torch.kernels import rbf_matvec as K
from repro_torch.launch import serve_gp
from repro_torch.obs import default_registry

# the module, which repro_torch.core.gp's `nll` function shadows
nll_mod = import_module("repro_torch.core.gp.nll")

pytestmark = pytest.mark.gpu

REL_TOL = 1e-5     # float32 sums of up to 8100 terms, relative to sum |k v|


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


RBF_MATVEC_GPU_SHAPES = [(256, 4, 8100, 2), (131, 4, 8099, 2),
                         (256, 4, 512, 2), (97, 3, 777, 3), (256, 2, 555, 8),
                         (64, 2, 300, 11), (256, 40, 810, 2), (1, 1, 1, 1),
                         (256, 1, 8100, 2), (256, 4, 16200, 2),
                         (200, 1, 8099, 2)]


def _rbf_matvec_inputs(dev, Nt, M, Ni, D):
    g = torch.Generator(dev).manual_seed(Nt + Ni)
    a = 3 * torch.rand(Nt, D, generator=g, device=dev)
    b = 3 * torch.rand(M, Ni, D, generator=g, device=dev)
    v = torch.randn(M, Ni, generator=g, device=dev)
    ls = 0.5 + torch.rand(D, generator=g, device=dev)
    return a, b, v, ls, torch.tensor([1.69], device=dev)


@pytest.mark.parametrize("Nt,M,Ni,D", RBF_MATVEC_GPU_SHAPES)
def test_kernel_matches_plain(cuda, Nt, M, Ni, D):
    a, b, v, ls, sf2 = _rbf_matvec_inputs(cuda, Nt, M, Ni, D)
    before = K.launches
    got = K.rbf_matvec(a, b, v, ls, sf2)
    assert K.launches == before + 1
    a, b, v, ls, sf2 = (t.double() for t in (a, b, v, ls, sf2))
    want = K.rbf_matvec_plain(a, b, v, ls, sf2)
    scale = K.rbf_matvec_plain(a, b, v.abs(), ls, sf2)
    assert got.shape == (M, Nt) and got.dtype == torch.float32
    assert float(((got.double() - want).abs() / scale).max()) <= REL_TOL


@pytest.mark.parametrize("Nt,M,Ni,D", RBF_MATVEC_GPU_SHAPES)
def test_kernel_is_bitwise_repeatable(cuda, Nt, M, Ni, D):
    """The cluster sums its partials in a fixed order: 20 calls equal."""
    args = _rbf_matvec_inputs(cuda, Nt, M, Ni, D)
    first = K.rbf_matvec(*args)
    assert all(torch.equal(K.rbf_matvec(*args), first) for _ in range(20))


@pytest.mark.parametrize("Nt,M,Ni,D", [(256, 4, 8100, 2), (256, 4, 512, 2),
                                       (256, 1, 8100, 2),
                                       (256, 4, 16200, 2)])
def test_kernel_is_one_device_launch_per_call(cuda, Nt, M, Ni, D):
    """One wrapper call is one kernel on the device and nothing else (no
    scratch fill, no second pass), at the serve and sparse tiles and at
    the grBCM tiles (the communication expert, M = 1, and the augmented
    experts, Ni = 16,200)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args = _rbf_matvec_inputs(cuda, Nt, M, Ni, D)
    K.rbf_matvec(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):       # a trace may lose its first device events
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        K.rbf_matvec(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and "spin_kernel" not in e.name]
    assert len(names) == 1 and "rbf_matvec" in names[0], names


def test_kernel_raises_on_cuda_float64(cuda, monkeypatch):
    """A CUDA tensor never takes the plain path, whatever its dtype."""
    def plain(*args):
        raise AssertionError("plain version reached from a CUDA tensor")
    monkeypatch.setattr(K, "rbf_matvec_plain", plain)
    a = torch.rand(8, 2, device=cuda, dtype=torch.float64)
    b = torch.rand(2, 5, 2, device=cuda, dtype=torch.float64)
    v = torch.rand(2, 5, device=cuda, dtype=torch.float64)
    before = K.launches
    with pytest.raises(TypeError, match="float32"):
        K.rbf_matvec(a, b, v, torch.ones(2, device=cuda, dtype=torch.float64),
                     torch.ones(1, device=cuda, dtype=torch.float64))
    assert K.launches == before


def test_fleet_defaults_to_the_card_and_streams_through_the_kernel(cuda):
    g = torch.Generator(cuda).manual_seed(0)
    X = 2 * torch.rand(4 * 500, 2, generator=g, device=cuda)
    X = X[torch.argsort(X[:, 0])]
    y = torch.sin(2 * X[:, 0]) * torch.cos(3 * X[:, 1])
    Xp, yp = X.reshape(4, 500, 2), y.reshape(4, 500)
    Xs = 2 * torch.rand(300, 2, generator=g, device=cuda)
    lt = pack([1.2, 0.3], 1.3, 0.1, dtype=torch.float32, device=cuda)
    fleet = GPFleet(FleetConfig(stream_mean=True)).fit(Xp, yp, log_theta0=lt,
                                                       train=False)
    assert fleet.device.type == "cuda"
    before = K.launches
    mean, var, _ = fleet.predict(Xs)
    assert K.launches == before + 2                  # 300 queries, 2 tiles
    dense = PredictionEngine(fleet.fitted, fleet.A, stream_mean=False)
    dmean, _, _ = dense.predict("rbcm", Xs)
    assert bool(torch.isfinite(mean).all()) and bool((var > 0).all())
    assert float((mean - dmean).abs().max()) <= 1e-4 * float(
        dmean.abs().max())


def test_serve_gp_on_the_card(cuda, capsys):
    serve_gp.main(["--agents", "4", "--per-agent", "256", "--requests", "8",
                   "--batch", "128"])
    assert "rbcm: served" in capsys.readouterr().out


def _cpu_and_card_fleets(cuda, method="rbcm"):
    """One float32 fleet (M = 4 stripes of 500 points, path graph) fitted
    on the CPU and on the card from the same numpy draw."""
    rng = np.random.default_rng(3)
    X = rng.uniform(0, 2, (2000, 2))
    X = X[np.argsort(X[:, 0])].astype(np.float32)
    y = (np.sin(2 * X[:, 0]) * np.cos(3 * X[:, 1])).astype(np.float32)
    Xs = rng.uniform(0, 2, (300, 2)).astype(np.float32)
    fleets = {}
    for dev in ("cpu", cuda):
        lt = pack([1.2, 0.3], 1.3, 0.1, dtype=torch.float32, device=dev)
        fleets[torch.device(dev).type] = GPFleet(
            FleetConfig(method=method, stream_mean=True), device=dev).fit(
            X.reshape(4, 500, 2), y.reshape(4, 500), log_theta0=lt,
            train=False)
    return fleets, Xs


@pytest.mark.parametrize("method", ["rbcm", "nn_rbcm", "npae"])
def test_degraded_predict_on_the_card_matches_the_cpu(cuda, method):
    """Dropout(0) with a NaN agent and a mid-run edge-lossy dropout: the
    card serves the CPU's census, and its float32 moments within the
    streamed mean's float32 rounding of the CPU's."""
    fleets, Xs = _cpu_and_card_fleets(cuda)
    for plan in (FaultPlan(dropouts=(Dropout(0),), nan_agents=(3,)),
                 FaultPlan(seed=7, dropouts=(Dropout(1, at=50, until=150),),
                           edge_loss=0.2)):
        before = K.launches
        mc, vc, ic = fleets["cuda"].predict(Xs, method=method,
                                            fault_plan=plan,
                                            allow_degraded=True)
        assert K.launches == before + (0 if method == "npae" else 2)
        m, v, i = fleets["cpu"].predict(Xs, method=method, fault_plan=plan,
                                        allow_degraded=True)
        for k in ("degraded", "alive_agents", "excluded_agents",
                  "n_components", "scrubbed_agents"):
            assert ic[k] == i[k], k
        assert float((mc.cpu() - m).abs().max()) <= 1e-3
        assert float((vc.cpu() - v).abs().max()) <= 1e-4


def test_scheduler_round_trip_on_the_card(cuda):
    """Two tenants of one ServingScheduler on the card (rbcm with a
    Dropout(0) plan, npae): ragged host requests come back as the fleet's
    own predictions, no geometry is new after warm-up, and rbcm's slots
    went through rbf_matvec."""
    fleets, Xs = _cpu_and_card_fleets(cuda)
    fleet = fleets["cuda"]
    plan = FaultPlan(dropouts=(Dropout(0),), fail_every=4)
    with fleet.to_server(batch=512) as srv:
        misses = fleet.jit_cache_misses
        before = K.launches
        reqs = [Xs[:n] for n in (1, 37, 256, 300)]
        answers = [f.result(timeout=120) for f in
                   [srv.submit(r) for r in reqs]]
        assert K.launches > before and fleet.jit_cache_misses == misses
    for r, (m, v) in zip(reqs, answers):
        want = fleet.predict(r)
        np.testing.assert_allclose(m, want[0].cpu().numpy(), atol=1e-5)
        np.testing.assert_allclose(v, want[1].cpu().numpy(), atol=1e-6)
    from repro_torch.launch.scheduler import ServingScheduler
    with ServingScheduler(max_wait_ms=1.0) as sched:
        sched.add_fleet("chaos", fleet, fault_plan=plan,
                        retry_backoff_ms=0.1)
        sched.add_fleet("npae", fleet, method="npae")
        misses = fleet.jit_cache_misses
        # one dispatch a request: the fourth call fails once, is retried
        got = {t: [sched.add_request(Xs[:100], tenant=t).result(timeout=120)
                   for _ in range(4)][-1] for t in ("chaos", "npae")}
        assert fleet.jit_cache_misses == misses
        assert sched.tenant_stats["chaos"].retried == 1
    want = fleet.predict(Xs[:100], fault_plan=plan, allow_degraded=True)
    np.testing.assert_allclose(got["chaos"][0], want[0].cpu().numpy(),
                               atol=1e-5)
    want = fleet.predict(Xs[:100], method="npae")
    np.testing.assert_allclose(got["npae"][0], want[0].cpu().numpy(),
                               atol=1e-5)


def _nll_grad_inputs(dev, M, N, D, seed):
    """d2u of random inputs, a symmetric `inner` and per-agent params."""
    g = torch.Generator(dev).manual_seed(seed)
    d2u = diff2_stack(2 * torch.rand(M, N, D, generator=g, device=dev))
    inner = torch.randn(M, N, N, generator=g, device=dev)
    inner = (inner + inner.mT) / 2
    ls = 0.3 + torch.rand(M, D, generator=g, device=dev)
    sf2 = 0.5 + torch.rand(M, 1, generator=g, device=dev)
    return d2u.contiguous(), inner, torch.cat([1 / ls**2, sf2], 1)


@pytest.mark.parametrize("M,N,D", [(4, 8100, 2), (4, 8099, 2), (4, 131, 2),
                                   (4, 1, 2), (4, 500, 1), (3, 257, 3),
                                   (2, 300, 8), (2, 64, 5), (40, 810, 2)])
def test_nll_grad_kernel_matches_plain(cuda, M, N, D):
    """Each component within 1e-5 of the float64 plain version, relative
    to its sum of absolute terms (sum |W d2u[d]|, sum |W|, sum |diag|),
    and two calls bitwise equal."""
    d2u, inner, params = _nll_grad_inputs(cuda, M, N, D, N + D)
    before = G.launches
    got = G.nll_grad(d2u, inner, params)
    again = G.nll_grad(d2u, inner, params)
    assert G.launches == before + 2
    assert got.shape == (M, D + 2) and got.dtype == torch.float32
    assert torch.equal(got, again)
    d2u, inner, params = d2u.double(), inner.double(), params.double()
    want = G.nll_grad_plain(d2u, inner, params)
    scale = G.nll_grad_plain(d2u, inner.abs(), params)
    assert bool(((got.double() - want).abs() <= REL_TOL * scale).all())


def test_nll_grad_kernel_matches_plain_near_the_augmented_shape(cuda):
    """gapx / dec-gapx run the kernel at N = 16,200 (d2u 2.1e9 elements,
    just under 2^31): N = 16,199 (not a multiple of 4, the scalar path)
    held per agent to the float64 plain version, each component within
    1e-5 of its sum of absolute terms."""
    M, N, D = 4, 16_199, 2
    d2u, inner, params = _nll_grad_inputs(cuda, M, N, D, 7)
    got = G.nll_grad(d2u, inner, params)
    for m in range(M):
        args = (d2u[m:m + 1].double(), inner[m:m + 1].double(),
                params[m:m + 1].double())
        want = G.nll_grad_plain(*args)[0]
        scale = G.nll_grad_plain(args[0], args[1].abs(), args[2])[0]
        assert bool(((got[m].double() - want).abs() <= REL_TOL * scale)
                    .all()), m


def test_nll_grad_kernel_raises_on_cuda_float64(cuda):
    d2u, inner, params = (t.double() for t in
                          _nll_grad_inputs(cuda, 2, 16, 2, 0))
    with pytest.raises(TypeError, match="float32"):
        G.nll_grad(d2u, inner, params)


def test_training_launches_nll_grad_once_per_iteration(cuda):
    """DEC-apx-GP on the card: one kernel launch per ADMM iteration for
    the whole fleet, and the same thetas (float32 rounding) as the loop
    with the plain version swapped in through the grad_fn hook."""
    g = torch.Generator(cuda).manual_seed(1)
    X = 2 * torch.rand(4 * 300, 2, generator=g, device=cuda)
    X = X[torch.argsort(X[:, 0])]
    y = torch.sin(2 * X[:, 0]) * torch.cos(3 * X[:, 1])
    Xp, yp = X.reshape(4, 300, 2), y.reshape(4, 300)
    lt0 = pack([2.0, 0.5], 1.0, 1.0, dtype=torch.float32, device=cuda)
    before = G.launches
    th, info = train_dec_apx_gp(lt0, Xp, yp, path_graph(4), iters=10)
    assert G.launches == before + 10
    assert info["residuals"].shape == (10,)

    def plain_grad(lt, Xi, yi):
        """The fused gradient with the kernel's plain version on the card."""
        d2u = diff2_stack(Xi)
        C, _ = cov_from_cache(lt, d2u)
        sums = G.nll_grad_plain(d2u, inner_from_cov(C, yi),
                                torch.cat([torch.exp(-2 * lt[:2]),
                                           torch.exp(2 * lt[2:3])]))
        return torch.cat([sums[:2] * torch.exp(-2 * lt[:2]), sums[2:3],
                          torch.exp(2 * lt[3:]) * sums[3:]])
    th_plain, _ = train_dec_apx_gp(lt0, Xp, yp, path_graph(4), iters=10,
                                   grad_fn=plain_grad)
    assert G.launches == before + 10
    assert float((th - th_plain).abs().max()) <= 1e-4


def _fleet_data(dev, M, N, seed):
    g = torch.Generator(dev).manual_seed(seed)
    X = 2 * torch.rand(M * N, 2, generator=g, device=dev)
    X = X[torch.argsort(X[:, 0])]
    y = torch.sin(2 * X[:, 0]) * torch.cos(3 * X[:, 1]) \
        + 0.1 * torch.randn(M * N, generator=g, device=dev)
    return X.reshape(M, N, 2), y.reshape(M, N)


def _inner_rel_err(got, want):
    """max over agents of max |got - want| / max |want|."""
    return float(((got.double() - want).abs().amax((1, 2))
                  / want.abs().amax((1, 2))).max())


def test_blocked_inverse_matches_float64_at_the_paper_size(cuda):
    """inner at N = 8,100 (blocked above INVERSE_EDGE) in float32, from
    the float32 factor, against float64 from the same factor: no further
    from it than the direct route (a solve against I and one product),
    and exactly symmetric."""
    Xp, yp = _fleet_data(cuda, 2, 8100, 11)
    lt = pack([1.2, 0.3], 1.3, 0.1, dtype=torch.float32, device=cuda)
    C, _ = cov_from_cache(lt.expand(2, -1), diff2_stack(Xp))
    L = nll_mod.cholesky(C)
    assert L.shape[-1] > nll_mod.INVERSE_EDGE
    want = nll_mod._inner_from_factor(L.double(), yp.double(), 10**9)
    blocked = nll_mod._inner_from_factor(L, yp, nll_mod.INVERSE_EDGE)
    assert torch.equal(blocked, blocked.mT)
    err = _inner_rel_err(blocked, want)
    del blocked
    direct = _inner_rel_err(nll_mod._inner_from_factor(L, yp, 10**9), want)
    assert err <= 2 * direct, (err, direct)


def test_training_above_the_edge_takes_the_blocked_route(cuda, monkeypatch):
    """DEC-apx-GP on 4 x 1,500 points: the route counter reads `blocked`
    once an iteration, and log theta lies within float32's own error
    (the direct route in float32 against float64 by autograd) of the
    direct route forced by a larger edge, as chip_smoke.py's train phase
    judges its kernel."""
    Xp, yp = _fleet_data(cuda, 4, 1500, 12)
    lt0 = pack([2.0, 0.5], 1.0, 1.0, dtype=torch.float32, device=cuda)
    kw = dict(A=path_graph(4), iters=5)
    route = default_registry().counter("gp_inner_from_cov_total")
    before = route.value(route="blocked")
    th_blocked, _ = train_dec_apx_gp(lt0, Xp, yp, **kw)
    assert route.value(route="blocked") == before + 5
    monkeypatch.setattr(nll_mod, "INVERSE_EDGE", 10**9)
    th_direct, _ = train_dec_apx_gp(lt0, Xp, yp, **kw)
    th_64, _ = train_dec_apx_gp(lt0.double(), Xp.double(), yp.double(),
                                grad_fn="autodiff", **kw)
    f32_error = float((th_direct.double() - th_64).abs().max())
    assert float((th_blocked - th_direct).abs().max()) <= f32_error


def _grbcm_data(dev, M=4, Ni=500, seed=5):
    g = torch.Generator(dev).manual_seed(seed)
    X = 2 * torch.rand(M * Ni, 2, generator=g, device=dev)
    X = X[torch.argsort(X[:, 0])]
    y = torch.sin(2 * X[:, 0]) * torch.cos(3 * X[:, 1])
    return X.reshape(M, Ni, 2), y.reshape(M, Ni), \
        2 * torch.rand(300, 2, generator=g, device=dev), g


@pytest.mark.parametrize("method", ["grbcm", "nn_grbcm", "cen_grbcm"])
def test_grbcm_fleet_streams_both_expert_sets_through_the_kernel(cuda,
                                                                 method):
    """A grbcm fleet on the card: per query tile one rbf_matvec launch for
    the augmented experts and one for the communication expert (M = 1),
    and the means of the same fleet served without the kernel."""
    Xp, yp, Xs, g = _grbcm_data(cuda)
    lt = pack([1.2, 0.3], 1.3, 0.1, dtype=torch.float32, device=cuda)
    fleet = GPFleet(FleetConfig(method="grbcm", stream_mean=True)).fit(
        Xp, yp, generator=g, log_theta0=lt, train=False)
    assert fleet.fitted_aug.Xp.shape == (4, 1000, 2)
    assert fleet.fitted_comm.Xp.shape == (1, 500, 2)
    before = K.launches
    mean, var, _ = fleet.predict(Xs, method=method)
    assert K.launches == before + 2 * 2              # 2 tiles x 2 sets
    dense = PredictionEngine(fleet.fitted, fleet.A, stream_mean=False,
                             fitted_aug=fleet.fitted_aug,
                             fitted_comm=fleet.fitted_comm)
    dmean, dvar, _ = dense.predict(method, Xs)
    assert bool(torch.isfinite(mean).all()) and bool((var > 0).all())
    assert float((mean - dmean).abs().max()) <= 1e-4 * float(
        dmean.abs().max())
    assert torch.equal(var, dvar)


def test_float64_factors_and_npae_on_the_card(cuda):
    """The C5 repair: a float64 batch of four factors solves on the card
    (two triangular solves, not torch.cholesky_solve), and every dense
    method serves float64 there as on the CPU."""
    Xp, yp, Xs, g = _grbcm_data(cuda, Ni=700)
    Xp, yp, Xs = Xp.double(), yp.double(), Xs.double()
    lt = pack([1.2, 0.3], 1.3, 0.1, dtype=torch.float64, device=cuda)
    kw = dict(method="grbcm", dac_iters=100, jor_iters=100, dale_iters=300,
              pm_iters=30)
    fleet = GPFleet(FleetConfig(**kw)).fit(Xp, yp, generator=g,
                                           log_theta0=lt, train=False)
    Xc, yc = fleet._comm_data[:2]
    cpu = GPFleet(FleetConfig(**kw), device="cpu").fit(
        Xp.cpu(), yp.cpu(), comm_data=(Xc.cpu(), yc.cpu()),
        log_theta0=lt.cpu(), train=False)
    assert float((fleet.fitted_aug.alpha.cpu() - cpu.fitted_aug.alpha)
                 .abs().max()) <= 1e-8 * float(cpu.fitted_aug.alpha.abs()
                                               .max())
    for method in ("grbcm", "npae", "npae_star", "nn_npae", "nn_rbcm",
                   "cen_npae"):
        mean, var, _ = fleet.predict(Xs, method=method)
        cmean, cvar, _ = cpu.predict(Xs.cpu(), method=method)
        assert mean.dtype == torch.float64
        assert float((mean.cpu() - cmean).abs().max()) <= 1e-7 * float(
            cmean.abs().max()), method
        assert float((var.cpu() - cvar).abs().max()) <= 1e-7 * float(
            cvar.abs().max()), method


@pytest.mark.parametrize("trainer", ["gapx", "dec-gapx"])
def test_gapx_trainers_launch_nll_grad_once_per_iteration(cuda, trainer):
    Xp, yp, _, g = _grbcm_data(cuda, Ni=300)
    before = G.launches
    fleet = GPFleet(FleetConfig(trainer=trainer, admm_iters=5,
                                kappa=10_000.0, lipschitz=10_000.0)).fit(
        Xp, yp, generator=g)
    assert G.launches == before + 5
    assert bool(torch.isfinite(fleet.log_theta).all())


def test_fleet_trains_on_the_card(cuda):
    g = torch.Generator(cuda).manual_seed(2)
    X = 2 * torch.rand(4 * 400, 2, generator=g, device=cuda)
    X = X[torch.argsort(X[:, 0])]
    y = torch.sin(2 * X[:, 0]) * torch.cos(3 * X[:, 1])
    fleet = GPFleet(FleetConfig(admm_iters=20, stream_mean=True)).fit(
        X.reshape(4, 400, 2), y.reshape(4, 400))
    assert bool(torch.isfinite(fleet.log_theta).all())
    assert fleet.thetas.shape == (4, 4)
    mean, var, _ = fleet.predict(X[:300])
    assert bool(torch.isfinite(mean).all()) and bool((var > 0).all())


def test_serve_gp_new_methods_on_the_card(cuda, capsys):
    serve_gp.main(["--agents", "4", "--per-agent", "256", "--requests", "4",
                   "--batch", "128", "--method", "nn-npae"])
    serve_gp.main(["--agents", "4", "--per-agent", "256", "--requests", "4",
                   "--batch", "128", "--method", "grbcm", "--trainer",
                   "dec-gapx", "--train-iters", "3"])
    out = capsys.readouterr().out
    assert "nn_npae: served" in out and "grbcm: served" in out
    assert "trained (dec-gapx, 3 rounds)" in out


def test_serve_gp_trains_on_the_card(cuda, capsys):
    serve_gp.main(["--agents", "4", "--per-agent", "256", "--requests", "4",
                   "--batch", "128", "--train-iters", "3"])
    out = capsys.readouterr().out
    assert "trained (dec-apx, 3 rounds)" in out and "rbcm: served" in out


def _factors(dev, M, n, seed):
    """Cholesky factors (row-major) of GP covariances of random inputs."""
    g = torch.Generator(dev).manual_seed(seed)
    X = 2 * torch.rand(M, n, 2, generator=g, device=dev)
    lt = pack([1.2, 0.3], 1.3, 0.1, dtype=torch.float32, device=dev)
    return torch.linalg.cholesky(cov_matrix(X, lt, 1e-8)).contiguous(), g


def _rel(got, want):
    return float(((got - want).abs().amax((1, 2))
                  / want.abs().amax((1, 2))).max())


def _cholupdate_shapes():
    """PR 14's shapes, then every panel and strip edge (strips and panels
    are 32 wide): n = 1, 31, 32, 33, 63, 64, 65, 777, 8,100 with shift 0,
    1, n - 1 and n."""
    shapes = [(4, 8100, 1), (4, 2049, 0), (3, 777, 1), (4, 131, 0),
              (2, 33, 1), (4, 1, 0)]
    for n in (1, 31, 32, 33, 63, 64, 65, 777, 8100):
        for shift in sorted({0, 1, n - 1, n}):
            if not any(s[1:] == (n, shift) for s in shapes):
                shapes.append((4 if n == 8100 else 3, n, shift))
    return shapes


@pytest.mark.parametrize("M,n,shift", _cholupdate_shapes())
def test_cholupdate_kernel_matches_plain(cuda, M, n, shift):
    """Update (and the eviction with shift > 0) bit for bit equal to the
    plain version on the card, upper triangle exactly zero, one wrapper
    launch; without a shift, the downdate by the same x too."""
    L, g = _factors(cuda, M, n, n)
    x = L[:, :, 0] if shift else 0.5 * torch.randn(M, n, generator=g,
                                                    device=cuda)
    before = C.launches
    got = C.cholupdate(L, x, shift=shift)
    assert C.launches == before + 1
    assert torch.equal(got, C.cholupdate_plain(L, x, shift=shift))
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))
    if not shift:
        down = C.cholupdate(got, x, downdate=True)
        assert C.launches == before + 2
        assert torch.equal(down, C.cholupdate_plain(got, x, downdate=True))


def test_cholupdate_zero_x_and_mask_are_bitwise(cuda):
    """A zero x leaves L bitwise; with 1, 2 or all 4 agents inactive the
    inactive ones come back as L and the whole result equals the plain
    version's bit for bit."""
    L, _ = _factors(cuda, 4, 300, 0)
    assert torch.equal(C.cholupdate(L, torch.zeros(4, 300, device=cuda)), L)
    for mask in ([True, False, True, True], [True, False, True, False],
                 [False] * 4):
        active = torch.tensor(mask, device=cuda)
        got = C.cholupdate(L, L[:, :, 0], shift=1, active=active)
        assert torch.equal(got[~active], L[~active])
        assert torch.equal(got, C.cholupdate_plain(L, L[:, :, 0], shift=1,
                                                   active=active))


def test_cholupdate_partial_window_is_bitwise(cuda):
    """A window holding 500 of 777 points: x = L[:, :, 0] is zero on the
    sentinel rows, whose columns the kernel skips as the plain one does."""
    from repro_torch.core.online import from_batch
    g = torch.Generator(cuda).manual_seed(5)
    X = 2 * torch.rand(4, 500, 2, generator=g, device=cuda)
    y = torch.sin(2 * X[..., 0])
    lt = pack([1.2, 0.3], 1.3, 0.1, dtype=torch.float32, device=cuda)
    L = from_batch(lt, X, y, window=777).L.contiguous()
    x = L[:, :, 0]
    assert bool((x[:, 500:] == 0).all())
    assert torch.equal(C.cholupdate(L, x, shift=1),
                       C.cholupdate_plain(L, x, shift=1))


def test_cholupdate_back_to_back_calls_are_bitwise(cuda):
    """200 calls in a row at the eviction shape of the paper's windows:
    every one finishes (no hang) and equals the first bit for bit (no
    race), which equals the plain version."""
    L, _ = _factors(cuda, 4, 8100, 8100)
    x = L[:, :, 0]
    first = C.cholupdate(L, x, shift=1)
    before = C.launches
    same = [torch.equal(C.cholupdate(L, x, shift=1), first)
            for _ in range(200)]
    C.check_faults()
    assert C.launches == before + 200 and all(same)
    assert torch.equal(first, C.cholupdate_plain(L, x, shift=1))


def test_cholupdate_two_device_launches_per_call(cuda):
    """One wrapper call is the scratch's fill and one cholupdate kernel on
    the device (besides the copy of its fault word)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    L, _ = _factors(cuda, 4, 1013, 1)
    x = L[:, :, 0]
    C.cholupdate(L, x, shift=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):       # a trace may lose its first device events
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        C.cholupdate(L, x, shift=1)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and not e.name.startswith("Memcpy")
             and "spin_kernel" not in e.name]
    assert len(names) == C.DEVICE_LAUNCHES_PER_CALL, names
    assert sum("cholupdate" in nm for nm in names) == 1, names


def test_cholupdate_fast_division_and_sqrt_are_the_intrinsics(cuda):
    """The kernel's branch-free division and square root equal __fdiv_rn
    and __fsqrt_rn bit for bit wherever their range check passes: every
    float in the square root's range, 2^30 pseudo-random divisions."""
    got = C.selfcheck(1 << 30, cuda)
    assert got["sqrt_checked"] > 1.9e9 and got["div_checked"] > 6e8, got
    assert got["sqrt_unequal"] == 0 and got["div_unequal"] == 0, got


def test_cholupdate_watchdog_raises_instead_of_hanging(cuda):
    """A panel whose rotations never arrive (withheld through the test
    hook) trips the watchdog: the call ends within its timeout, the fault
    is raised by check_faults (and, unchecked, by the next call), and the
    call after that is right again."""
    L, g = _factors(cuda, 2, 300, 2)
    x = 0.5 * torch.randn(2, 300, generator=g, device=cuda)
    C._launch(L, x, False, 0, None, timeout_s=0.05, never_publish=3)
    with pytest.raises(RuntimeError, match="panel 3 of agent 0 never "
                                           "arrived"):
        C.check_faults()
    C._launch(L, x, False, 0, None, timeout_s=0.05, never_publish=3)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="panel 3 of agent 0"):
        C.cholupdate(L, x)
    got = C.cholupdate(L, x)
    C.check_faults()
    assert torch.equal(got, C.cholupdate_plain(L, x))


def test_cholupdate_op_casts_float64_and_the_kernel_refuses_it(cuda):
    """The op casts a float64 CUDA factor to float32 for the kernel and
    back; the kernel's wrapper itself takes float32 only."""
    L, g = _factors(cuda, 2, 64, 1)
    x = torch.randn(2, 64, generator=g, device=cuda)
    before = C.launches
    out = ops.cholupdate_fleet(L.double(), x.double())
    assert C.launches == before + 1 and out.dtype == torch.float64
    assert _rel(out, C.cholupdate_plain(L.double(), x.double())) <= 1e-5
    with pytest.raises(TypeError, match="float32"):
        C.cholupdate(L.double(), x.double())


def test_streaming_fleet_on_the_card(cuda):
    """GPFleet(online=True) on the card: one cholupdate launch per full
    observe round, factors within float32 reach of a refit, drift through
    nll_grad, join/leave, and serving from the swapped factors."""
    g = torch.Generator(cuda).manual_seed(3)
    X = 2 * torch.rand(4 * 300 + 4 * 20 + 200, 2, generator=g, device=cuda)
    y = torch.sin(2 * X[:, 0]) * torch.cos(3 * X[:, 1])
    Xp, yp = X[:1200].reshape(4, 300, 2), y[:1200].reshape(4, 300)
    lt = pack([1.2, 0.3], 1.3, 0.1, dtype=torch.float32, device=cuda)
    fleet = GPFleet(FleetConfig(online=True, window=300, stream_mean=True,
                                kappa=10_000.0)).fit(Xp, yp, log_theta0=lt,
                                                     train=False)
    engine = fleet.engine
    before = C.launches
    for r in range(20):
        fleet.observe(X[1200 + 4 * r:1204 + 4 * r],
                      y[1200 + 4 * r:1204 + 4 * r])
    assert C.launches == before + 20
    st = fleet._online_state
    ref = refit(st)
    assert _rel(st.L, ref.L) <= 1e-3
    mean, var, _ = fleet.predict(X[-200:])
    assert fleet.engine is engine and engine.fitted.L is st.L
    assert bool(torch.isfinite(mean).all()) and bool((var > 0).all())
    before = G.launches
    fleet.drift(iters=2)
    assert G.launches == before + 2
    fleet.join(X[:300], y[:300])
    fleet.leave(1)
    mean, _, _ = fleet.predict(X[-200:])
    assert fleet.num_agents == 4 and bool(torch.isfinite(mean).all())


def test_serve_gp_online_on_the_card(cuda, capsys):
    serve_gp.main(["--agents", "4", "--per-agent", "256", "--requests", "8",
                   "--batch", "128", "--online", "--observe-every", "2"])
    out = capsys.readouterr().out
    assert "online rbcm: served" in out and "factors swapped" in out


@pytest.mark.parametrize("M,m,N,D,col0,width,noise", [
    (4, 512, 8100, 2, 0, 4096, False), (4, 512, 100_000, 2, 98_304, 4096,
                                        False),
    (1, 1013, 1013, 2, 0, 1013, True), (3, 97, 777, 3, 0, 777, False),
    (2, 64, 555, 8, 0, 555, False), (4, 1, 7, 2, 0, 7, False),
    (2, 40, 300, 11, 0, 300, False)])
def test_rbf_gram_kernel_matches_plain(cuda, M, m, N, D, col0, width, noise):
    """The shapes of chip_smoke.py's kernels phase (and D = 11 on the
    generic path): max |error| within 1e-5 sigma_f^2 of the float64 plain
    version, the columns past N exactly 0."""
    g = torch.Generator(cuda).manual_seed(m + N)
    x = 3 * torch.rand(M, N, D, generator=g, device=cuda)
    z = x[:, :m].contiguous() if noise else \
        3 * torch.rand(M, m, D, generator=g, device=cuda)
    params = torch.tensor([1.69, 0.01], device=cuda)
    before = RG.launches
    got = RG.rbf_gram(z, x, params, noise, col0, width)
    assert RG.launches == before + 1
    want = RG.rbf_gram_plain(z.double(), x.double(), params.double(), noise,
                             col0, width)
    valid = min(width, N - col0)
    assert got.shape == (M, m, width) and got.dtype == torch.float32
    assert float((got.double() - want).abs().max()) <= 1e-5 * 1.69
    assert bool((got[..., valid:] == 0).all())


def test_rbf_gram_kernel_raises_on_cuda_float64(cuda):
    z = torch.rand(2, 5, 2, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        RG.rbf_gram(z, z, torch.ones(2, device=cuda, dtype=torch.float64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sparse_fit_launches_rbf_gram_once_per_panel(cuda, dtype):
    """GPFleet(sparse_m=...) with no device given runs on the card: one
    rbf_gram launch per 4,096-column panel for the whole fleet
    (ceil(5,000 / 4,096) = 2), and serves rBCM and npae_sparse. m = 16
    keeps Kmm well conditioned, so float32 holds too (at m = 512 on the
    paper fleet it does not: chip_smoke.py's SPARSE_F32)."""
    g = torch.Generator(cuda).manual_seed(3)
    X = 2 * torch.rand(4 * 5000 + 300, 2, generator=g, device=cuda,
                       dtype=dtype)
    Xp = X[:20000][torch.argsort(X[:20000, 0])].reshape(4, 5000, 2)
    yp = (torch.sin(2 * Xp[..., 0]) * torch.cos(3 * Xp[..., 1]))
    lt = pack([1.2, 0.3], 1.3, 0.1, dtype=dtype, device=cuda)
    before = RG.launches
    fleet = GPFleet(FleetConfig(sparse_m=16, stream_mean=True)).fit(
        Xp, yp, log_theta0=lt, train=False)
    assert fleet.device.type == "cuda" and RG.launches == before + 2
    for method in ("rbcm", "npae_sparse"):
        mean, var, _ = fleet.predict(X[-300:], method=method)
        assert mean.dtype == dtype and bool(torch.isfinite(mean).all())
        assert bool((var > 0).all())
    assert RG.launches == before + 2


def test_serve_gp_sparse_on_the_card(cuda, capsys):
    serve_gp.main(["--agents", "4", "--per-agent", "512", "--requests", "8",
                   "--batch", "128", "--sparse-m", "32", "--method",
                   "npae-sparse"])
    out = capsys.readouterr().out
    assert "sparse m=32" in out and "npae_sparse: served" in out


# flash_attention (B, H, KH, Sq, Sk, D, causal, window, dtype): the
# prefill of internlm2-1.8b, a sliding window whose first key blocks are
# wholly masked for the late queries, bf16, ragged S, the decode shape,
# D = 64 and D = 32, not causal, Sq < Sk ragged; then the edges of the
# kernel's 128-row query block and 64-key tile: S of 127, 128, 129 and
# 191, Sk - Sq not a multiple of the key tile, a window that masks whole
# leading key tiles of a block, bf16 at D = 128 (its dropped passes)
FLASH_CASES = [
    (4, 16, 8, 2048, 2048, 128, True, None, torch.float32),
    (1, 16, 8, 2048, 2048, 128, True, 512, torch.float32),
    (2, 16, 8, 1024, 1024, 128, True, None, torch.bfloat16),
    (1, 16, 8, 1000, 1000, 128, True, None, torch.float32),
    (4, 16, 8, 1, 2081, 128, True, None, torch.float32),
    (2, 8, 4, 777, 777, 64, True, None, torch.float32),
    (1, 4, 1, 203, 203, 32, True, 50, torch.float32),
    (1, 4, 2, 130, 130, 64, False, None, torch.float32),
    (2, 4, 2, 65, 300, 32, True, None, torch.bfloat16),
    (1, 4, 2, 127, 127, 128, True, None, torch.float32),
    (1, 4, 2, 128, 128, 128, True, None, torch.float32),
    (1, 4, 2, 129, 129, 128, True, None, torch.float32),
    (1, 4, 2, 191, 191, 64, False, None, torch.float32),
    (1, 4, 2, 191, 191, 32, True, None, torch.bfloat16),
    (1, 4, 2, 129, 300, 64, True, None, torch.float32),
    (1, 4, 2, 640, 640, 128, True, 100, torch.float32),
    (1, 8, 2, 300, 300, 128, True, None, torch.bfloat16),
    # the LM families' modes: whisper's cross-attention with more queries
    # than keys (no mask) and at a decode step, GQA 6 (dbrx) in bf16 and
    # float32 with Sq > Sk, GQA 8 (internvl2)
    (2, 12, 12, 300, 150, 64, False, None, torch.float32),
    (2, 12, 12, 1, 1500, 64, False, None, torch.float32),
    (1, 12, 2, 257, 200, 128, False, None, torch.bfloat16),
    (1, 12, 2, 200, 130, 128, False, None, torch.float32),
    (2, 48, 8, 300, 300, 128, True, None, torch.bfloat16),
    (1, 64, 8, 150, 150, 128, True, None, torch.float32)]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,causal,window,dtype", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, B, H, KH, Sq, Sk, D,
                                              causal, window, dtype):
    """Max |error| within FLASH_TOL of max |plain output|; one launch per
    call; two calls bitwise equal; finite everywhere."""
    g = torch.Generator(cuda).manual_seed(Sq + D)
    q = torch.randn(B, H, Sq, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, KH, Sk, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, KH, Sk, D, generator=g, device=cuda).to(dtype)
    before = F.launches
    got = F.flash_attention(q, k, v, causal, window)
    again = F.flash_attention(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert F.launches == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    want = F.flash_attention_plain(q, k, v, causal, window).float()
    err = float((got.float() - want).abs().max())
    assert err <= FLASH_TOL[dtype] * float(want.abs().max())


def test_flash_attention_kernel_refuses_float16_and_sq_above_sk(cuda):
    q = torch.zeros(1, 2, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        F.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 9, 64, device=cuda)
    kv = torch.zeros(1, 2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="no admitted key"):
        ops.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="no admitted key"):
        ops.flash_attention(q, kv, kv, causal=False, window=4)


def test_lm_serves_through_flash_attention_on_the_card(cuda):
    """Reduced internlm2-1.8b: one kernel launch per layer in the prefill
    and none in decode; the prefill logits against the same model with
    the plain version swapped in; prefill + one decode step against the
    parallel forward over P + 1 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, steps
    from repro_torch.models import LM
    cfg = get_config("internlm2-1.8b").reduced().with_overrides(
        num_kv_heads=2)
    g = torch.Generator(cuda).manual_seed(0)
    model = LM(cfg, generator=g)
    prompts = torch.randint(0, cfg.vocab_size, (2, 100), generator=g,
                            device=cuda)
    out = serve.generate(model, prompts, 4)
    assert out["prefill_launches"] == cfg.num_layers
    assert out["decode_launches"] == 0
    plain = serve.generate(model, prompts, 4,
                           attention=ops_plain_attention)
    want = plain["prefill_logits"]
    assert float((out["prefill_logits"] - want).abs().max()) <= \
        1e-5 * float(want.abs().max())
    _, cache = steps.make_prefill_step(cfg, 104)(model, prompts)
    ld, _ = steps.make_decode_step(cfg)(model, cache, prompts[:, :1])
    with torch.no_grad():
        lf, _, _ = model(torch.cat([prompts, prompts[:, :1]], 1),
                         logits_slice=1)
    assert float((ld[:, -1] - lf[:, -1]).abs().max()) < 5e-4


def ops_plain_attention(q, k, v, causal=True, window=None, scale=None):
    return F.flash_attention_plain(q, k, v, causal, window, scale)


def test_serve_lm_on_the_card(cuda, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "internlm2-1.8b", "--reduced", "--batch", "2",
                "--prompt-len", "64", "--gen", "4"])
    out = capsys.readouterr().out
    assert "on cuda" in out and \
        "2 in the prefill (2 attention layers)" in out


# the training path's attention (B, H, KH, Sq, Sk, D, causal, window,
# dtype): GQA at head_dim 128, a window, Sq < Sk ragged, not causal, bf16
FLASH_GRAD_CASES = [
    (2, 16, 8, 512, 512, 128, True, None, torch.float32),
    (1, 8, 2, 300, 300, 64, True, 100, torch.float32),
    (1, 4, 2, 129, 300, 64, True, None, torch.float32),
    (1, 4, 4, 191, 191, 32, False, None, torch.float32),
    (2, 8, 4, 256, 256, 128, True, None, torch.bfloat16),
    (1, 6, 1, 300, 150, 64, False, None, torch.float32)]
# gradients, max |error| relative to max |plain gradient|: the same
# backward on both sides, fed the kernel's out and lse (float32 rounding)
# or bf16 outputs rounded to 8 bits
FLASH_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _flash_inputs(cuda, B, H, KH, Sq, Sk, D, dtype, seed):
    g = torch.Generator(cuda).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=cuda).to(dtype)
            for shape in ((B, H, Sq, D), (B, KH, Sk, D), (B, KH, Sk, D),
                          (B, H, Sq, D))]


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,causal,window,dtype",
                         FLASH_GRAD_CASES)
def test_flash_attention_lse_matches_plain(cuda, B, H, KH, Sq, Sk, D,
                                           causal, window, dtype):
    """The kernel's log-sum-exp against the plain version's within 1e-5
    (1 + |lse|); its output with the lse on is bitwise the output without
    (serving's launch)."""
    q, k, v, _ = _flash_inputs(cuda, B, H, KH, Sq, Sk, D, dtype, Sq)
    out, lse = F.flash_attention_lse(q, k, v, causal, window)
    plain_out, plain_lse = F.flash_attention_plain_lse(q, k, v, causal,
                                                       window)
    torch.cuda.synchronize()
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    assert torch.equal(out, F.flash_attention(q, k, v, causal, window))
    assert float(((lse - plain_lse).abs()
                  / (1 + plain_lse.abs())).max()) <= 1e-5


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,causal,window,dtype",
                         FLASH_GRAD_CASES)
def test_flash_attention_function_gradients_match_plain(cuda, B, H, KH, Sq,
                                                        Sk, D, causal,
                                                        window, dtype):
    """ops.flash_attention with inputs that require grad: one kernel
    launch forward, and dq, dk, dv of the ported backward against autograd
    through the plain version."""
    q, k, v, do = _flash_inputs(cuda, B, H, KH, Sq, Sk, D, dtype, Sk)
    qkv = [t.requires_grad_() for t in (q, k, v)]
    before = F.launches
    out = ops.flash_attention(*qkv, causal=causal, window=window)
    assert out.grad_fn is not None and F.launches == before + 1
    got = torch.autograd.grad(out, qkv, do)
    want = torch.autograd.grad(
        F.flash_attention_plain(*qkv, causal, window), qkv, do)
    assert F.launches == before + 1
    for g_, w_ in zip(got, want):
        assert g_.dtype == dtype and bool(torch.isfinite(g_).all())
        assert float((g_.float() - w_.float()).abs().max()) <= \
            FLASH_GRAD_TOL[dtype] * float(w_.float().abs().max())


def _reduced_lm(cuda, remat=False):
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    cfg = get_config("internlm2-1.8b").reduced().with_overrides(
        num_kv_heads=2, remat=remat)
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 96),
                                     generator=torch.Generator()
                                     .manual_seed(4))}
    batch["labels"] = batch["tokens"].roll(-1, 1)
    return cfg, model, batch


def test_attention_weights_receive_gradients_on_the_card(cuda):
    """The fault this slice repairs: with grad mode on, attention on the
    card goes through FlashAttentionFunction, so wq, wk and wv get
    gradients, equal to those with the plain version swapped in."""
    import copy
    from repro_torch.models import lm
    cfg, cpu_model, batch = _reduced_lm(cuda)
    model = copy.deepcopy(cpu_model).to(cuda)
    batch = {k: v.to(cuda) for k, v in batch.items()}
    grads = {}
    for name, attention in (("kernel", None), ("plain", ops_plain_attention)):
        model.zero_grad(set_to_none=True)
        loss, _ = lm.loss_fn(cfg, model, batch, attention=attention)
        loss.backward()
        grads[name] = {n: p.grad.clone() for n, p in
                       model.named_parameters()}
    for n, want in grads["plain"].items():
        got = grads["kernel"][n]
        assert float(want.abs().max()) > 0
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max()), n
    for blk in model.blocks:
        for w in (blk.attn.wq, blk.attn.wk, blk.attn.wv):
            assert w.grad is not None


def test_reduced_train_step_on_the_card_matches_the_cpu(cuda):
    """One remat Adam step of the reduced LM on the card against the same
    step on the CPU: 2 x layers kernel launches (forward and the
    recompute), the loss within 1e-5, the parameters within the reference
    microbatch test's tolerances where the update saturates (see
    tests/test_torch_lm_train.py) and 2 lr everywhere."""
    import copy
    from repro_torch.launch import steps
    from repro_torch.optim import adam
    cfg, cpu_model, batch = _reduced_lm(cuda, remat=True)
    p0 = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}
    model = copy.deepcopy(cpu_model).to(cuda)
    lr = 1e-3
    losses = []
    for m, dev in ((cpu_model, "cpu"), (model, cuda)):
        opt = adam(lr)
        state = opt.init(dict(m.named_parameters()))
        before = F.launches
        _, loss, _ = steps.make_train_step(cfg, opt)(
            m, state, {k: v.to(dev) for k, v in batch.items()})
        losses.append(float(loss))
        assert F.launches - before == (0 if dev == "cpu"
                                       else 2 * cfg.num_layers)
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])
    cpu = dict(cpu_model.named_parameters())
    for n, p in model.named_parameters():
        got, want = p.detach().cpu(), cpu[n].detach()
        sat = (want - p0[n]).abs() >= lr / 2
        assert torch.allclose(got[sat], want[sat], rtol=2e-3, atol=2e-4), n
        assert float((got - want).abs().max()) <= 2 * lr


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b",
                                  "jamba-v0.1-52b", "internvl2-76b",
                                  "whisper-small", "xlstm-350m"])
def test_lm_families_serve_on_the_card_as_on_the_cpu(cuda, arch):
    """The reduced MoE, jamba, VLM and whisper models (jamba at 4 layers:
    both mamba kinds) served on the card and on the CPU from the same
    float32 weights and inputs: the kernel launched once per attention
    product of the prefill (and, for whisper, once per decoder layer a
    decode step), prefill and decode logits within 1e-4 of max |logit|,
    the CPU's greedy tokens fed to both."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, steps
    from repro_torch.models import build_model
    cfg = get_config(arch).reduced(
        layers=4 if arch.startswith("jamba") else 2)
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(cuda)
    frames, embeds = serve.stub_inputs(cfg, 2, torch.Generator()
                                       .manual_seed(1), "cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 40),
                            generator=torch.Generator().manual_seed(2))
    G = 4
    pre = steps.make_prefill_step(cfg, 40 + G + cfg.vis_tokens + 1)
    dec = steps.make_decode_step(cfg)
    outs = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        before = F.launches
        if cfg.encdec:
            logits, cache, enc = pre(model, frames.to(dev), prompts.to(dev))
        else:
            logits, cache = pre(model, prompts.to(dev),
                                None if embeds is None else embeds.to(dev))
        seen = [logits[:, -1].float().cpu()]
        launches = [F.launches - before]
        for step in range(G):
            tok = outs["cpu"][step].argmax(-1)[:, None].to(dev) \
                if name == "card" else seen[-1].argmax(-1)[:, None]
            before = F.launches
            if cfg.encdec:
                logits, cache = dec(model, cache, enc, tok)
            else:
                logits, cache = dec(model, cache, tok)
            launches.append(F.launches - before)
            seen.append(logits[:, -1].float().cpu())
        outs[name] = seen
        outs[name + "_launches"] = launches
    attn = serve.attention_layers(cfg)
    per_step = cfg.num_layers if cfg.encdec else 0
    assert outs["card_launches"] == [attn] + [per_step] * G
    for got, want in zip(outs["card"], outs["cpu"]):
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())


def test_mlstm_chunked_matches_sequential_on_the_card(cuda):
    """The chunked mLSTM (4 chunks of 64) against mlstm_sequential over
    256 steps from a non-empty state, at xlstm-350m's head width, float32
    on the card: h and the final state within 1e-4 of their max."""
    from repro_torch.models import xlstm
    g = torch.Generator(cuda).manual_seed(0)
    B, H, S, hd, L = 2, 4, 256, 256, 64

    def draw(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    q, k, v = draw(B, H, S, hd), draw(B, H, S, hd), draw(B, H, S, hd)
    lf = torch.nn.functional.logsigmoid(draw(B, H, S) + 3)
    li = draw(B, H, S)
    state = {"C": draw(B, H, hd, hd), "n": draw(B, H, hd),
             "m": draw(B, H)}
    hs, st = [], state
    for c0 in range(0, S, L):
        sl = slice(c0, c0 + L)
        h, st = xlstm._mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                   lf[..., sl], li[..., sl], st)
        hs.append(h)
    h_seq, st_seq = xlstm.mlstm_sequential(q, k, v, lf, li, state)
    assert float((torch.cat(hs, 2) - h_seq).abs().max()) <= \
        1e-4 * float(h_seq.abs().max())
    for n in ("C", "n", "m"):
        assert float((st[n] - st_seq[n]).abs().max()) <= \
            1e-4 * float(st_seq[n].abs().max()), n


def test_placed_prefill_under_a_mesh_on_the_card(cuda):
    """Reduced internlm2 placed on make_test_mesh(1, 1) by its parameters'
    specs: a prefill under use_mesh (constrain live: a CPU tensor raises)
    bit for bit the unplaced prefill, one kernel launch a layer."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh, sharding, steps
    from repro_torch.models import LM, act_sharding
    cfg = get_config("internlm2-1.8b").reduced()
    g = torch.Generator(cuda).manual_seed(0)
    model = LM(cfg, generator=g)
    prompts = torch.randint(0, cfg.vocab_size, (2, 100), generator=g,
                            device=cuda)
    prefill = steps.make_prefill_step(cfg, 101)
    want, _ = prefill(model, prompts)
    m = mesh.make_test_mesh(1, 1)
    assert m.devices == (torch.device("cuda:0"),)
    sharding.place(model, m, steps.model_param_specs(model, m))
    before = F.launches
    with act_sharding.use_mesh(m):
        got, _ = prefill(model, prompts)
        with pytest.raises(ValueError, match="not on the mesh"):
            act_sharding.constrain(torch.zeros(2, 1), ("batch", None))
    assert F.launches - before == cfg.num_layers
    assert torch.equal(got, want)
