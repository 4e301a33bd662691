"""The port's checkpoints (repro_torch.checkpoint, GPFleet.save/load)
against the JAX package's format, on the CPU in float64.

* `leaf_keys` spells leaf paths as `jax.tree_util.keystr` does.
* `restore` reports missing, extra, shape and dtype mismatches, and a
  save leaves no temp file.
* For the four kinds of fleet (dense, online windows, sparse m = 16,
  grBCM augmented + communication experts; M = 4, Ni = 40): a fleet saved
  by the JAX package loads into the port and serves its predictions to
  1e-12 relative, a fleet saved by the port loads into the JAX package and
  serves the port's predictions to 1e-12 (grBCM's variance to 1e-11: it
  is 1 / (sum_i 1/var_i - (M-1)/var_c), a difference of precisions that
  turns the two packages' rounding of the factors' solves into 2e-12 of
  it here), both write the same leaf keys,
  shapes and dtypes, and the port's own save -> load serves bit for bit
  the same predictions (and, online, the same observe round).

One module-scoped fitted fleet per kind and package; no test refits. The
parity tests import JAX inside their fixtures: the `gpu` tests at the end
import none, so on the card

    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_checkpoint.py

runs save -> load -> bitwise-equal predictions for the dense and online
kinds there.
"""
import json
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (LeafSpec, latest_step, leaf_keys,
                                    load_checkpoint, restore,
                                    save_checkpoint)
from repro_torch.fleet import FleetConfig, GPFleet

torch.set_num_threads(2)

TOL = 1e-12
GRBCM_VAR_TOL = 1e-11
LOG_THETA = np.log([1.2, 0.3, 1.3, 0.1])
M, NI = 4, 40
SMALL = dict(chunk=16, dac_iters=100)
KINDS = {
    "dense": dict(SMALL),
    "online": dict(SMALL, online=True, window=48),
    "sparse": dict(SMALL, sparse_m=16),
    "grbcm": dict(SMALL, method="grbcm"),
}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    X = rng.uniform(0, 2, (M * NI, 2))
    X = X[np.argsort(X[:, 0])]
    y = np.sin(2 * X[:, 0]) * np.cos(X[:, 1]) + 0.1 * rng.normal(size=len(X))
    obs = (rng.uniform(0, 2, (M, 2)), rng.normal(size=M))
    return (X.reshape(M, NI, 2), y.reshape(M, NI), rng.uniform(0, 2, (24, 2)),
            obs)


@pytest.fixture(scope="module")
def jax_fleets(data, tmp_path_factory):
    """{kind: (fitted JAX fleet, its save directory)}."""
    import jax
    import jax.numpy as jnp
    from repro.fleet import FleetConfig as JFleetConfig
    from repro.fleet import GPFleet as JGPFleet
    Xp, yp, _, _ = data
    out = {}
    for kind, kw in KINDS.items():
        fleet = JGPFleet(JFleetConfig(**kw)).fit(
            jnp.asarray(Xp), jnp.asarray(yp), key=jax.random.PRNGKey(1),
            log_theta0=jnp.asarray(LOG_THETA), train=False)
        d = str(tmp_path_factory.mktemp(f"jax_{kind}"))
        fleet.save(d)
        out[kind] = (fleet, d)
    return out


@pytest.fixture(scope="module")
def port_fleets(data, tmp_path_factory):
    """{kind: (fitted port fleet, its save directory)}."""
    Xp, yp, _, _ = data
    out = {}
    for kind, kw in KINDS.items():
        fleet = GPFleet(FleetConfig(**kw), device="cpu").fit(
            Xp, yp, generator=torch.Generator().manual_seed(1),
            log_theta0=LOG_THETA, train=False)
        d = str(tmp_path_factory.mktemp(f"port_{kind}"))
        fleet.save(d)
        out[kind] = (fleet, d)
    return out


# -- the checkpoint format ---------------------------------------------------

class Pair(NamedTuple):
    a: object
    b: object
    opt: object = None


def _tree():
    return {"w": torch.arange(6.0).reshape(2, 3),
            "pair": Pair(torch.ones(4), torch.zeros((2, 2), dtype=torch.float32)),
            "n": torch.tensor(3, dtype=torch.int32),
            "seq": [np.ones(2), (np.zeros(1), 2.5)], "none": None}


def test_leaf_keys_match_jax_keystr():
    import jax
    tree = _tree()
    jtree = jax.tree.map(lambda t: np.asarray(t), tree)
    want = [jax.tree_util.keystr(kp)
            for kp, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert leaf_keys(tree) == want


def test_roundtrip_bit_identical_and_manifest(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 7, tree)
    out = restore(str(tmp_path), tree, step=7)
    assert isinstance(out["pair"], Pair) and out["pair"].opt is None
    assert out["none"] is None and isinstance(out["seq"][1], tuple)
    assert leaf_keys(out) == leaf_keys(tree)
    torch.testing.assert_close(out["w"], tree["w"], rtol=0, atol=0)
    assert out["n"].dtype == torch.int32 and out["n"].shape == ()
    with open(tmp_path / "manifest.json") as f:
        man = json.load(f)
    assert man["step"] == 7
    assert man["leaves"]["['n']"] == {"shape": [], "dtype": "int32"}
    assert man["leaves"]["['pair'].b"] == {"shape": [2, 2],
                                           "dtype": "float32"}
    save_checkpoint(str(tmp_path), 9, tree)
    assert latest_step(str(tmp_path)) == 9
    assert sorted(os.listdir(tmp_path)) == [
        "manifest.json", "step_00000007.npz", "step_00000009.npz"]
    unchecked = load_checkpoint(str(tmp_path), 9, tree)
    assert torch.equal(unchecked["pair"].a, tree["pair"].a)


@pytest.mark.parametrize("case", ["missing", "extra", "shape", "dtype"])
def test_restore_reports_mismatch_like_reference(tmp_path, case):
    """The port's restore fails where the reference's does, with the same
    report."""
    import jax
    from repro.checkpoint import restore as jrestore
    save_checkpoint(str(tmp_path), 0, {"x": np.zeros(2), "y": np.ones(3)})
    tmpl = {"missing": {"x": (2,), "y": (3,), "z": (1,)},
            "extra": {"x": (2,)},
            "shape": {"x": (2,), "y": (4,)},
            "dtype": {"x": (2,), "y": (3,)}}[case]
    dt = "float32" if case == "dtype" else "float64"
    ours = {k: LeafSpec(s, dt if k == "y" else "float64")
            for k, s in tmpl.items()}
    theirs = {k: jax.ShapeDtypeStruct(s, dt if k == "y" else "float64")
              for k, s in tmpl.items()}
    with pytest.raises(ValueError) as e_ours:
        restore(str(tmp_path), ours)
    with pytest.raises(ValueError) as e_theirs:
        jrestore(str(tmp_path), theirs)
    assert str(e_ours.value) == str(e_theirs.value)


# -- fleets across the two packages -----------------------------------------

def _predict_port(fleet, Xs):
    return fleet.predict(Xs)[:2]


@pytest.mark.parametrize("kind", list(KINDS))
def test_jax_saved_fleet_serves_in_port(data, jax_fleets, kind):
    import jax.numpy as jnp
    _, _, Xs, _ = data
    jfleet, d = jax_fleets[kind]
    fleet = GPFleet.load(d, device="cpu")
    assert fleet.config.to_dict() == jfleet.config.to_dict()
    field = "LS" if kind == "sparse" else "L"
    assert torch.equal(getattr(fleet.fitted, field), torch.tensor(
        np.asarray(getattr(jfleet.fitted, field))))
    jm, jv, _ = jfleet.predict(jnp.asarray(Xs))
    m, v = _predict_port(fleet, Xs)
    _close(m, jm)
    _close(v, jv, GRBCM_VAR_TOL if kind == "grbcm" else TOL)


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_saved_fleet_serves_in_jax(data, port_fleets, kind):
    import jax.numpy as jnp
    from repro.fleet import GPFleet as JGPFleet
    _, _, Xs, _ = data
    fleet, d = port_fleets[kind]
    jfleet = JGPFleet.load(d)
    m, v = _predict_port(fleet, Xs)
    jm, jv, _ = jfleet.predict(jnp.asarray(Xs))
    _close(jm, m)
    _close(jv, v, GRBCM_VAR_TOL if kind == "grbcm" else TOL)


@pytest.mark.parametrize("kind", list(KINDS))
def test_both_packages_write_the_same_leaves(jax_fleets, port_fleets, kind):
    def leaves(d):
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)["leaves"]

    def components(d):
        with open(os.path.join(d, "fleet.json")) as f:
            return json.load(f)["components"]
    assert leaves(port_fleets[kind][1]) == leaves(jax_fleets[kind][1])
    assert components(port_fleets[kind][1]) == \
        components(jax_fleets[kind][1])
    assert not [f for d in (port_fleets[kind][1],)
                for f in os.listdir(d) if "tmp" in f]


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_save_load_bit_identical(data, port_fleets, kind):
    _, _, Xs, _ = data
    fleet, d = port_fleets[kind]
    loaded = GPFleet.load(d, device="cpu")
    (m0, v0), (m1, v1) = _predict_port(fleet, Xs), _predict_port(loaded, Xs)
    assert torch.equal(m0, m1) and torch.equal(v0, v1)
    assert loaded.is_fitted and loaded.train_info == {}


def test_online_fleet_streams_after_load(data, jax_fleets, port_fleets,
                                         tmp_path):
    """One observe round after loading: the port's copy of the JAX-saved
    window state follows the JAX fleet (1e-9, the streaming parity of
    tests/test_torch_online.py), and the port's reloaded fleet follows
    its saving fleet bit for bit."""
    import jax.numpy as jnp
    from repro.fleet import GPFleet as JGPFleet
    _, _, Xs, (xs, ys) = data
    jfleet = JGPFleet.load(jax_fleets["online"][1])
    jfleet.observe(jnp.asarray(xs), jnp.asarray(ys))
    fleet = GPFleet.load(jax_fleets["online"][1], device="cpu")
    assert fleet.window_counts.dtype == torch.int32
    fleet.observe(xs, ys)
    jm, jv, _ = jfleet.predict(jnp.asarray(Xs))
    m, v = _predict_port(fleet, Xs)
    _close(m, jm, 1e-9)
    _close(v, jv, 1e-9)

    # the saving fleet streams here: no later test reads it
    saved, d = port_fleets["online"]
    twin = GPFleet.load(d, device="cpu")
    counts = saved.window_counts.clone()
    twin.observe(xs, ys)
    saved.observe(xs, ys)
    for a, b in zip(twin._online_state, saved._online_state):
        assert torch.equal(a, b)
    assert torch.equal(twin.window_counts, counts + 1)


def test_load_rejects_a_corrupted_leaf(port_fleets, tmp_path):
    fleet, _ = port_fleets["dense"]
    fleet.save(str(tmp_path))
    path = tmp_path / "step_00000000.npz"
    stored = dict(np.load(path))
    stored["['fitted'].L"] = stored["['fitted'].L"][:, :-1]
    np.savez(path, **stored)
    with pytest.raises(ValueError, match="template shape"):
        GPFleet.load(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match="fleet.json"):
        GPFleet.load(str(tmp_path / "nowhere"), device="cpu")


# -- on the card (no JAX) ----------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("online", [False, True])
def test_gpu_save_load_bitwise(cuda, tmp_path, online):
    """float32 on the card: predictions (the streamed mean through
    rbf_matvec) after load equal those before, bit for bit; online, so
    does the next observe round (cholupdate)."""
    g = torch.Generator(cuda).manual_seed(5)
    Xp = 2 * torch.rand(4, 300, 2, generator=g, device=cuda)
    yp = torch.sin(3 * Xp[..., 0]) + 0.1 * torch.randn(4, 300, generator=g,
                                                       device=cuda)
    Xs = 2 * torch.rand(300, 2, generator=g, device=cuda)
    cfg = FleetConfig(stream_mean=True, online=online,
                      window=320 if online else None)
    fleet = GPFleet(cfg, device=cuda).fit(Xp, yp, log_theta0=LOG_THETA,
                                          train=False)
    fleet.save(str(tmp_path))
    loaded = GPFleet.load(str(tmp_path), device=cuda)
    assert loaded.fitted.L.device.type == "cuda"
    m0, v0, _ = fleet.predict(Xs)
    m1, v1, _ = loaded.predict(Xs)
    assert torch.equal(m0, m1) and torch.equal(v0, v1)
    if online:
        xs = 2 * torch.rand(4, 2, generator=g, device=cuda)
        ys = torch.randn(4, generator=g, device=cuda)
        fleet.observe(xs, ys)
        loaded.observe(xs, ys)
        for a, b in zip(fleet._online_state, loaded._online_state):
            assert torch.equal(a, b)
        assert torch.equal(fleet.predict(Xs)[0], loaded.predict(Xs)[0])
