"""The port's federated consensus (core/federated.py) and federated LM
train step on the CPU against the JAX package.

The reference's federated functions run inside a mapped mesh axis; here
they run under `jax.vmap(..., axis_name="data")` over a leading agent
axis, where `ppermute` and `pmean` bind without devices. The port runs
the same numpy inputs as one dict per member on ("cpu",) * M meshes
(ring hops between members of one device), in float64 to 1e-12. The
federated train step runs the reduced internlm2-1.8b (one layer) in
float32 on both sides from the reference's initial parameters and the
agents' MarkovLMData batches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import federated as jfed
from repro.data.lm_data import MarkovLMData as JMarkovLMData
from repro.launch.steps import make_federated_train_step as jfed_step
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.core import federated
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_agent_mesh
from repro_torch.models.convert import lm_params_from_jax, lm_tree_to_jax

torch.set_num_threads(2)

TOL = 1e-12                      # float64, the same arithmetic
SHAPES = {"a": (3,), "b": (2, 4)}
CFG = jfed.ConsensusConfig(strategy="dec_admm", rho=0.7, kappa=5.0,
                           dac_eps=0.3, dac_sweeps=2)
FUNCTIONS = ["allreduce_grads", "dac_grads", "dec_admm_init",
             "dec_admm_update", "consensus_disagreement"]
# the federated step: loss relative; parameters relative to each leaf's
# max |theta| (float32 gradients in another order, divided by kappa)
STEP_LOSS_TOL, STEP_PARAM_TOL = 1e-5, 1e-6


def _stacked(rng, M):
    return {k: rng.normal(size=(M,) + s) for k, s in SHAPES.items()}


def _members(tree, M):
    """One dict of float64 tensors per member of a ("cpu",) * M mesh."""
    mesh = make_agent_mesh(M, devices=("cpu",) * M)
    assert mesh.size == M
    return [{k: torch.from_numpy(v[i]).to(d) for k, v in tree.items()}
            for i, d in enumerate(mesh.devices)]


def _stack(members):
    return {k: np.stack([m[k].numpy() for m in members])
            for k in members[0]}


def _reference(name, p, d, g):
    vmap = lambda fn, *a: jax.vmap(fn, axis_name="data")(*a)  # noqa: E731
    if name == "allreduce_grads":
        return vmap(lambda x: jfed.allreduce_grads(x, ("data",)), g)
    if name == "dac_grads":
        return vmap(lambda x: jfed.dac_grads(x, ("data",), CFG), g)
    if name == "dec_admm_init":
        return jfed.dec_admm_init(p)
    if name == "dec_admm_update":
        return vmap(lambda *a: jfed.dec_admm_update(*a, "data", CFG), p, d,
                    g)
    return vmap(lambda x: jfed.consensus_disagreement(x, "data"), p)


@pytest.mark.parametrize("M", [1, 2, 4])
@pytest.mark.parametrize("name", FUNCTIONS)
def test_federated_functions_match_reference(name, M):
    rng = np.random.default_rng(M)
    p, d, g = (_stacked(rng, M) for _ in range(3))
    want = _reference(name, *({k: jnp.asarray(v) for k, v in t.items()}
                              for t in (p, d, g)))
    tp, td, tg = (_members(t, M) for t in (p, d, g))
    if name == "allreduce_grads":
        got = federated.allreduce_grads(tg)
    elif name == "dac_grads":
        got = federated.dac_grads(tg, CFG)
    elif name == "dec_admm_init":
        got = federated.dec_admm_init(tp)
    elif name == "dec_admm_update":
        got = federated.dec_admm_update(tp, td, tg, CFG)
    else:
        got = federated.consensus_disagreement(tp)
        assert all(x.shape == () for x in got)
        np.testing.assert_allclose([float(x) for x in got],
                                   np.asarray(want), rtol=TOL, atol=TOL)
        return
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    for g_, w_ in pairs:
        assert len(g_) == M
        for k, v in _stack(g_).items():
            assert v.dtype == np.float64
            np.testing.assert_allclose(v, np.asarray(w_[k]), rtol=TOL,
                                       atol=TOL)


def test_dac_grads_keep_the_mean_and_the_two_ring_counts_once():
    """Perron sweeps keep the members' mean; a two-member ring adds its one
    neighbour once (degree 1), so one sweep at eps 1/2 averages exactly."""
    rng = np.random.default_rng(9)
    tg = _members(_stacked(rng, 4), 4)
    out = federated.dac_grads(tg, federated.ConsensusConfig(dac_sweeps=3))
    for k in SHAPES:
        np.testing.assert_allclose(sum(m[k] for m in out).numpy(),
                                   sum(m[k] for m in tg).numpy(), atol=1e-12)
    two = _members(_stacked(rng, 2), 2)
    avg = federated.dac_grads(two, federated.ConsensusConfig(dac_eps=0.5))
    for k in SHAPES:
        np.testing.assert_allclose(avg[0][k].numpy(), avg[1][k].numpy(),
                                   atol=1e-15)


@pytest.fixture(scope="module")
def tiny():
    """(reference config, port config, initial parameters as numpy) of
    internlm2-1.8b reduced to one layer."""
    jcfg = jget_config("internlm2-1.8b").reduced(layers=1, d_model=128)
    cfg = get_config("internlm2-1.8b").reduced(layers=1, d_model=128)
    params = jax.tree.map(np.asarray, jax.jit(
        jlm.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(1)))
    return jcfg, cfg, params


@pytest.mark.parametrize("exchange", [True, False])
@pytest.mark.parametrize("M", [2, 4])
def test_federated_train_step_matches_reference(tiny, M, exchange):
    """Two steps of make_federated_train_step over M agents (one LM per
    agent on a ("cpu",) * M mesh, each with its own MarkovLMData shard)
    against the reference's stacked step: the mean loss, every agent's
    parameters and duals."""
    jcfg, cfg, params = tiny
    rho, kappa = 0.5, 50.0
    datas = [JMarkovLMData(cfg.vocab_size, seed=0, agent=a)
             for a in range(M)]
    batches = [[dict(zip(("tokens", "labels"), d.batch(2, 16)))
                for d in datas] for _ in range(2)]
    jstep = jax.jit(jfed_step(jcfg, n_agents=M, rho=rho, kappa=kappa,
                              exchange=exchange))
    jp = jax.tree.map(lambda t: jnp.broadcast_to(t, (M,) + t.shape), params)
    jd = jax.tree.map(jnp.zeros_like, jp)
    step = steps.make_federated_train_step(cfg, n_agents=M, rho=rho,
                                           kappa=kappa, exchange=exchange)
    mesh = make_agent_mesh(M, devices=("cpu",) * M)
    models = [lm_params_from_jax(cfg, params, device=d)
              for d in mesh.devices]
    duals = federated.dec_admm_init([dict(m.named_parameters())
                                     for m in models])
    for bs in batches:
        jb = {k: jnp.stack([jnp.asarray(b[k]) for b in bs])
              for k in ("tokens", "labels")}
        jp, jd, jl = jstep(jp, jd, jb)
        duals, loss = step(models, duals, [
            {k: torch.from_numpy(v).long() for k, v in b.items()}
            for b in bs])
        assert abs(float(loss) - float(jl)) <= STEP_LOSS_TOL * float(jl)
    for a, model in enumerate(models):
        got = jax.tree.leaves(lm_tree_to_jax(
            model, dict(model.named_parameters())))
        dual = jax.tree.leaves(lm_tree_to_jax(model, duals[a]))
        for g, w, dg, dw in zip(got, jax.tree.leaves(jp), dual,
                                jax.tree.leaves(jd)):
            w, dw = np.asarray(w[a]), np.asarray(dw[a])
            assert np.abs(g - w).max() <= STEP_PARAM_TOL * np.abs(w).max()
            assert np.abs(dg - dw).max() <= \
                STEP_PARAM_TOL * max(np.abs(w).max(), 1.0)
