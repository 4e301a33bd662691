"""The port on a CUDA card: the hand-written rbf_matvec kernel against its
plain version, its dispatch, and the serving path with and without it.

Every test here is marked `gpu` and skips (in its fixture) without a card.
This file imports no JAX, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.core.gp import pack
from repro_torch.core.prediction import PredictionEngine
from repro_torch.fleet import FleetConfig, GPFleet
from repro_torch.kernels import rbf_matvec as K
from repro_torch.launch import serve_gp

pytestmark = pytest.mark.gpu

REL_TOL = 1e-5     # float32 sums of up to 8100 terms, relative to sum |k v|


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("Nt,M,Ni,D", [(256, 4, 8100, 2), (131, 4, 8099, 2),
                                       (97, 3, 777, 3), (256, 2, 555, 8),
                                       (64, 2, 300, 11), (256, 40, 810, 2),
                                       (1, 1, 1, 1)])
def test_kernel_matches_plain(cuda, Nt, M, Ni, D):
    g = torch.Generator(cuda).manual_seed(Nt + Ni)
    a = 3 * torch.rand(Nt, D, generator=g, device=cuda)
    b = 3 * torch.rand(M, Ni, D, generator=g, device=cuda)
    v = torch.randn(M, Ni, generator=g, device=cuda)
    sf2 = torch.tensor([1.69], device=cuda)
    before = K.launches
    got = K.rbf_matvec(a, b, v, sf2)
    assert K.launches == before + 1
    want = K.rbf_matvec_plain(a.double(), b.double(), v.double(),
                              sf2.double())
    scale = K.rbf_matvec_plain(a.double(), b.double(), v.double().abs(),
                               sf2.double())
    assert got.shape == (M, Nt) and got.dtype == torch.float32
    assert float(((got.double() - want).abs() / scale).max()) <= REL_TOL


def test_kernel_raises_on_cuda_float64(cuda):
    """A CUDA tensor never takes the plain path, whatever its dtype."""
    a = torch.rand(8, 2, device=cuda, dtype=torch.float64)
    b = torch.rand(2, 5, 2, device=cuda, dtype=torch.float64)
    v = torch.rand(2, 5, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        K.rbf_matvec(a, b, v, torch.ones(1, device=cuda,
                                          dtype=torch.float64))


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
