"""The port's rbf_matvec and rbf_gram kernel modules on the CPU: their plain
versions against the JAX package's oracle and Pallas kernel (interpret
mode), the batched ops against per-agent calls, and the dispatch rule — a
CPU tensor takes the plain version, any other tensor goes to the CUDA
kernel or raises.

The kernel itself runs only on a card: tests/test_torch_gpu.py holds it to
the plain version there.
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import ops, ref
from repro_torch.kernels import nll_grad as G
from repro_torch.kernels import rbf_gram as RG
from repro_torch.kernels import rbf_matvec as K

torch.set_num_threads(2)

KERNEL_DIR = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels"


def _inputs(n, m, d, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(dtype),
            rng.normal(size=(m, d)).astype(dtype),
            rng.normal(size=m).astype(dtype),
            np.full(d, 0.8, dtype), 1.3)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("n,m,d", [(100, 130, 2), (64, 97, 1), (33, 50, 5)])
def test_plain_f64_matches_reference_oracle(n, m, d):
    """float64 plain version (direct differences) vs the reference's Gram
    oracle (expansion): the two forms differ by rounding only, 1e-12
    relative to max|ref|."""
    x1, x2, v, ls, sf = _inputs(n, m, d)
    got = ops.rbf_matvec(torch.from_numpy(x1), torch.from_numpy(x2),
                         torch.from_numpy(v), torch.from_numpy(ls),
                         torch.tensor(sf, dtype=torch.float64))
    assert got.dtype == torch.float64
    want = jref.rbf_matvec_ref(jnp.asarray(x1), jnp.asarray(x2),
                               jnp.asarray(v), jnp.asarray(ls), sf)
    assert _rel(got, want) <= 1e-12
    own = ref.rbf_matvec_ref(*(torch.from_numpy(a) for a in (x1, x2, v, ls)),
                             sf)
    assert _rel(got, own) <= 1e-12


@pytest.mark.parametrize("n,m,d", [(100, 130, 2), (256, 256, 3), (300, 70, 5),
                                   (64, 512, 1)])
def test_plain_f32_matches_pallas_interpret(n, m, d):
    """float32 plain version vs the reference's Pallas kernel run in
    interpret mode, as tests/test_extensions.py runs it. Both accumulate
    up to 512 float32 terms in different orders and forms; a check of
    interpret mode against float64 measured 4.5e-6, so 2e-5 relative to
    max|ref|."""
    x1, x2, v, ls, sf = _inputs(n, m, d, seed=1, dtype=np.float32)
    got = ops.rbf_matvec(torch.from_numpy(x1), torch.from_numpy(x2),
                         torch.from_numpy(v), torch.from_numpy(ls),
                         torch.tensor(sf, dtype=torch.float32))
    assert got.dtype == torch.float32
    want = jops.rbf_matvec(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(v),
                           jnp.asarray(ls), sf, use_pallas=True,
                           interpret=True)
    assert _rel(got, want) <= 2e-5


def test_batched_op_equals_per_agent_calls():
    rng = np.random.default_rng(2)
    Xs = torch.from_numpy(rng.normal(size=(29, 2)))
    Xp = torch.from_numpy(rng.normal(size=(4, 41, 2)))
    alpha = torch.from_numpy(rng.normal(size=(4, 41)))
    ls, sf = torch.tensor([1.2, 0.3], dtype=torch.float64), \
        torch.tensor(1.3, dtype=torch.float64)
    out = ops.rbf_matvec_agents(Xs, Xp, alpha, ls, sf**2)
    assert out.shape == (4, 29)
    for m in range(4):
        assert _rel(out[m], ops.rbf_matvec(Xs, Xp[m], alpha[m], ls, sf)) \
            <= 1e-12


def test_cpu_path_never_loads_the_library(monkeypatch):
    def fail(name):
        raise AssertionError("the CPU path must not build or load CUDA code")
    monkeypatch.setattr(_build, "load_library", fail)
    K._library.cache_clear()
    a, b, v = torch.rand(5, 2), torch.rand(3, 7, 2), torch.rand(3, 7)
    out = K.rbf_matvec(a, b, v, torch.tensor([0.5, 2.0]), torch.tensor([2.0]))
    assert out.shape == (3, 5)


def test_non_cpu_tensor_raises_when_the_loader_fails(monkeypatch):
    """A tensor off the CPU goes to the kernel: when the library cannot be
    built or loaded the error propagates, and the plain version never
    runs. Meta tensors stand in for CUDA tensors on a machine without a
    card, with the device check waived."""
    def fail(name):
        raise RuntimeError("nvcc not found")

    def plain(*args):
        raise AssertionError("plain version reached from a non-CPU tensor")
    monkeypatch.setattr(_build, "load_library", fail)
    monkeypatch.setattr(K, "rbf_matvec_plain", plain)
    monkeypatch.setattr(K, "_check", lambda *args: None)
    K._library.cache_clear()
    meta = dict(device="meta", dtype=torch.float32)
    before = K.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops.rbf_matvec_agents(torch.empty(8, 2, **meta),
                              torch.empty(3, 9, 2, **meta),
                              torch.empty(3, 9, **meta),
                              torch.ones(2, **meta), torch.ones((), **meta))
    assert K.launches == before


@pytest.mark.parametrize("bad,match", [
    ("device", "CUDA device"), ("dtype", "float32"),
    ("contiguous", "contiguous"), ("shape", "want a"),
    ("lengthscales", "want a")])
def test_kernel_input_checks_raise(bad, match):
    """The launch wrapper refuses what the kernel does not take; meta
    tensors stand in for CUDA tensors, so every case also fails the device
    test, which comes last."""
    meta = dict(device="meta", dtype=torch.float32)
    a, b, v = (torch.empty(8, 2, **meta), torch.empty(3, 9, 2, **meta),
               torch.empty(3, 9, **meta))
    if bad == "dtype":
        a = a.double()
    elif bad == "contiguous":
        b = torch.empty(3, 2, 9, **meta).transpose(1, 2)
    elif bad == "shape":
        v = torch.empty(3, 8, **meta)
    ls = torch.empty(3 if bad == "lengthscales" else 2, **meta)
    with pytest.raises((ValueError, TypeError), match=match):
        K._check(a, b, v, ls, torch.empty(1, **meta))


@pytest.mark.parametrize("module", ["rbf_matvec.py", "ops.py", "nll_grad.py",
                                    "cholupdate.py", "rbf_gram.py"])
def test_dispatch_has_no_fallback(module):
    """No `try` in the dispatch modules: nothing can catch a kernel failure
    and fall back to the plain version."""
    tree = ast.parse((KERNEL_DIR / module).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_build_hash_tracks_the_source_and_flags():
    p = _build.library_path("rbf_matvec")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("librbf_matvec-")
    src = (_build.CSRC / "rbf_matvec.cu").read_text()
    assert "rbf_matvec_pallas" in src    # the source names what it replaces
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_nll_grad_build_names_its_tpu_kernel():
    p = _build.library_path("nll_grad")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("libnll_grad-")
    src = (_build.CSRC / "nll_grad.cu").read_text()
    assert "nll_grad_pallas" in src      # the source names what it replaces
    assert "atomic" not in src.replace("no atomics", "")


def test_nll_grad_blocks_fill_the_card():
    # the training shape: 16 blocks per SM over 4 agents
    assert G.blocks_for(4, 8100, 132) == 528
    assert G.blocks_for(40, 810, 132) == 53
    assert G.blocks_for(4, 1, 132) == 1            # never more than rows


def test_cholupdate_build_names_its_tpu_kernel():
    p = _build.library_path("cholupdate")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("libcholupdate-")
    src = (_build.CSRC / "cholupdate.cu").read_text()
    assert "cholupdate_pallas" in src     # the source names what it replaces
    assert "fast_math" not in " ".join(_build.NVCC_FLAGS)   # IEEE sqrt, div


def test_cholupdate_cpu_path_never_loads_the_library(monkeypatch):
    from repro_torch.kernels import cholupdate as C

    def fail(name):
        raise AssertionError("the CPU path must not build or load CUDA code")
    monkeypatch.setattr(_build, "load_library", fail)
    C._library.cache_clear()
    L = torch.linalg.cholesky(torch.eye(5, dtype=torch.float64) * 4)
    before = C.launches
    out = ops.cholupdate(L, torch.ones(5, dtype=torch.float64))
    assert out.dtype == torch.float64 and C.launches == before


@pytest.mark.parametrize("with_noise", [False, True])
@pytest.mark.parametrize("n,m,d", [(100, 100, 2), (256, 300, 3), (77, 77, 5),
                                   (1, 1, 1)])
def test_rbf_gram_f32_matches_pallas_interpret(n, m, d, with_noise):
    """float32 plain version (direct differences) vs the reference's Pallas
    kernel in interpret mode (the expansion ||a||^2 + ||b||^2 - 2ab, which
    cancels to about |a|^2 eps(float32) = 1e-6 in d2 at these scaled
    inputs): 1e-5 relative to sigma_f^2 + noise^2, the largest entry."""
    x1, x2, _, ls, sf = _inputs(n, m, d, seed=3, dtype=np.float32)
    if with_noise:                     # the square case
        x2, m = x1, n
    noise = np.float32(0.3)
    got = ops.rbf_gram(torch.from_numpy(x1), torch.from_numpy(x2),
                       torch.from_numpy(ls), torch.tensor(sf), noise,
                       with_noise=with_noise)
    assert got.dtype == torch.float32 and got.shape == (n, m)
    want = jops.rbf_gram(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ls),
                         sf, noise, with_noise=with_noise, use_pallas=True,
                         interpret=True)
    scale = sf ** 2 + (noise ** 2 if with_noise else 0.0)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * scale


@pytest.mark.parametrize("with_noise", [False, True])
def test_rbf_gram_f64_matches_reference_oracle(with_noise):
    """float64 op vs the reference's oracle ref.rbf_gram_ref and the port's
    own: the direct differences and the expansion differ by rounding only,
    1e-12 relative to the largest entry."""
    x1, x2, _, ls, sf = _inputs(90, 90, 2, seed=4)
    x2 = x1 if with_noise else x2
    noise = 0.2 if with_noise else 0.0
    got = ops.rbf_gram(torch.from_numpy(x1), torch.from_numpy(x2),
                       torch.from_numpy(ls), sf, noise, with_noise=with_noise)
    assert got.dtype == torch.float64
    want = jref.rbf_gram_ref(jnp.asarray(x1), jnp.asarray(x2),
                             jnp.asarray(ls), sf, noise)
    assert _rel(got, want) <= 1e-12
    own = ref.rbf_gram_ref(torch.from_numpy(x1), torch.from_numpy(x2),
                           torch.from_numpy(ls), sf, noise)
    assert _rel(got, own) <= 1e-12


def test_rbf_gram_panels_and_the_zero_tail():
    """Column panels of the kernel's wrapper tile the fleet op's whole
    Gram; a panel that runs past an agent's N points is exactly 0 there,
    and the global diagonal of with_noise follows the panel's column
    offset."""
    rng = np.random.default_rng(7)
    Z = torch.from_numpy(rng.normal(size=(3, 11, 2)))
    X = torch.from_numpy(rng.normal(size=(3, 29, 2)))
    ls, sf = torch.tensor([0.7, 1.1], dtype=torch.float64), 1.3
    full = ops.rbf_gram_agents(Z, X, ls, sf)
    assert full.shape == (3, 11, 29)
    params = torch.tensor([sf ** 2, 0.25], dtype=torch.float64)
    for col0 in (0, 8, 16, 24):
        panel = RG.rbf_gram(Z / ls, X / ls, params, col0=col0, width=8)
        valid = min(8, 29 - col0)
        assert torch.equal(panel[..., :valid], full[..., col0:col0 + valid])
        assert bool((panel[..., valid:] == 0).all())
    Zs = (X[:, :11] / ls).contiguous()
    diff = RG.rbf_gram(Zs, X / ls, params, True, 8, 8) \
        - RG.rbf_gram(Zs, X / ls, params, False, 8, 8)
    assert torch.allclose(diff[:, 8, 0], torch.full((3,), 0.25,
                                                    dtype=torch.float64))
    assert int((diff != 0).sum()) == 3 * 3       # rows 8, 9, 10


def test_rbf_gram_cpu_path_never_loads_the_library(monkeypatch):
    def fail(name):
        raise AssertionError("the CPU path must not build or load CUDA code")
    monkeypatch.setattr(_build, "load_library", fail)
    RG._library.cache_clear()
    before = RG.launches
    out = ops.kmn_stats(torch.rand(4, 2), torch.rand(9, 2), torch.rand(9),
                        torch.ones(2), 1.0, bn=4)
    assert out[0].shape == (4, 4) and RG.launches == before


def test_rbf_gram_build_names_its_tpu_kernel():
    p = _build.library_path("rbf_gram")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("librbf_gram-")
    src = (_build.CSRC / "rbf_gram.cu").read_text()
    assert "rbf_gram_pallas" in src      # the source names what it replaces
    assert "exp2f" in src and "atomic" not in src
