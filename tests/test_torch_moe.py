"""The port's MoE transformer family on the CPU against the JAX package:
`moe_ffn` (output, auxiliary loss, the capacity dispatch and its dropped
choices, drop-free decode), and dbrx-132b and llama4-maverick (its
dense + MoE group, top-1) reduced through `forward`, prefill + greedy
decode (`launch.steps`), `loss_fn` and every parameter's gradient, and
the parameter layout round trip.

Inputs are drawn with numpy, weights by the reference's own initializer
in float64 and handed over through `models.convert`. The router's logits
are float32 in both packages whatever the model's dtype (the reference's
`.astype(jnp.float32)`), and so are the normalized top-k weights that
combine the experts' outputs, and the attention's products (both
packages' flash attention computes in float32): the outputs agree to
float32 rounding, not float64's, and are held to ROUTED_TOL. The
dispatch itself (which choice takes which slot, which drop) is 0/1 and
held exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models import lm, moe
from repro_torch.models.convert import (lm_params_from_jax,
                                        lm_params_to_jax, lm_tree_to_jax)

torch.set_num_threads(2)

# max |error| relative to max |reference value|: float32 router weights
# (about 6e-8 relative) and float32 attention carried through float64
# products; measured below 1e-6
ROUTED_TOL = 1e-5
ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]


def _rel(got, want):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@functools.cache
def _tree(arch):
    """The reference's float64 parameters of the reduced `arch`, drawn
    once a session by its own initializer (jitted)."""
    jcfg = jget_config(arch).reduced()
    return jax.tree.map(np.asarray, jax.jit(
        lambda key: jlm.init_params(jcfg, key, jnp.float64))(
            jax.random.PRNGKey(0)))


def _setup(arch):
    """(cfg, reference cfg, reference tree, a fresh port model of it)."""
    cfg = get_config(arch).reduced()
    tree = _tree(arch)
    return (cfg, jget_config(arch).reduced(), tree,
            lm_params_from_jax(cfg, tree, device="cpu"))


def _reference_moe(jcfg, monkeypatch):
    """The reference's moe_ffn, jitted, returning (out, aux, disp, comb):
    its (disp, comb) come out through its act_sharding hook (a no-op
    without a mesh), which it calls on both."""
    seen = []

    def constrain(x, axes):
        if tuple(axes) == ("batch", None, "experts", None):
            seen.append(x)
        return x
    monkeypatch.setattr(jmoe, "constrain", constrain)

    def run(p, x):
        seen.clear()
        out, aux = jmoe.moe_ffn(p, x, jcfg)
        return out, aux, seen[0], seen[1]
    return jax.jit(run)


@pytest.mark.parametrize("S", [48, 1])
def test_moe_ffn_matches_reference(S, monkeypatch):
    """One MoE FFN on float64 inputs: a prefill-sized batch of 2 x 48
    tokens (groups of 32, capacity 20 of 64 choices a group, with the
    router biased towards expert 0 so that choices drop), and a decode
    step (S = 1: drop-free, capacity g k)."""
    cfg, jcfg, tree, model = _setup("dbrx-132b")
    p = jax.tree.map(lambda t: t[0], tree["blocks"]["moe"]["moe"])
    p["router"] = p["router"].copy()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, S, cfg.d_model))
    x[..., :8] += 2.0
    p["router"][:8, 0] += 0.5
    layer = model.blocks[0].moe
    with torch.no_grad():
        layer.router.copy_(torch.from_numpy(p["router"]))
    want, want_aux, disp_ref, comb_ref = _reference_moe(jcfg, monkeypatch)(
        p, jnp.asarray(x))
    got, aux = moe.moe_ffn(layer, torch.from_numpy(x), cfg)
    assert got.dtype == torch.float64 and aux.dtype == torch.float32
    assert _rel(got, want) <= ROUTED_TOL
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))

    g, cap = moe.capacity(cfg, 2, S)
    assert (g, cap) == ((32, 20) if S > 1 else (2, 4))
    xt = torch.from_numpy(x).reshape(-1, g, cfg.d_model)
    disp, comb, _ = moe.route(layer, xt, cfg, cap)
    assert np.array_equal(disp.numpy(), np.asarray(disp_ref))
    assert _rel(comb, comb_ref) <= ROUTED_TOL
    kept = float(disp.sum())
    k = cfg.experts_per_token
    if S > 1:
        assert kept < xt.shape[0] * g * k        # choices past capacity drop
    else:
        assert kept == xt.shape[0] * g * k       # decode keeps every choice


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch):
    """Reference tree -> port model -> tree is bit for bit, and the
    model's blocks follow the reference's layer order."""
    cfg, _, tree, model = _setup(arch)
    back = lm_params_to_jax(model)
    flat, treedef = jax.tree.flatten(tree)
    flat2, treedef2 = jax.tree.flatten(back)
    assert treedef == treedef2
    for a, b in zip(flat, flat2):
        assert a.shape == b.shape and np.array_equal(a, b)
    kinds = [kind for kind, *_ in model.plan]
    k = cfg.moe_every
    assert kinds == (["attn"] * (k - 1) + ["attn_moe"]) * \
        (cfg.num_layers // k)
    assert lm.param_count(cfg) == sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg, jcfg, tree, model = _setup(arch)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 40))
    want, want_aux, _ = jax.jit(lambda p, t: jlm.forward(jcfg, p, t))(
        tree, jnp.asarray(toks))
    got, aux, cache = model(torch.from_numpy(toks))
    assert cache is None and got.dtype == torch.float64
    assert _rel(got, want) <= ROUTED_TOL
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * float(want_aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_reference_steps(arch):
    """Prefill + 6 greedy decode steps through the reference's steps and
    the port's, the reference's tokens fed to both; the port's greedy pick
    equal wherever the reference's top-2 gap exceeds the tolerance."""
    cfg, jcfg, tree, model = _setup(arch)
    P, G = 24, 6
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, P))
    jpre = jax.jit(jsteps.make_prefill_step(jcfg, max_len=P + G + 1))
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    lj, cj = jpre(tree, jnp.asarray(toks, jnp.int32))
    lt, ct = steps.make_prefill_step(cfg, P + G + 1)(
        model, torch.from_numpy(toks))
    tdec = steps.make_decode_step(cfg)
    for step in range(G + 1):
        lj_ = np.asarray(lj)[:, -1]
        assert _rel(lt[:, -1], lj_) <= ROUTED_TOL, step
        top2 = np.sort(lj_, -1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > ROUTED_TOL * np.abs(lj_).max()
        tok = lj_.argmax(-1)
        assert np.array_equal(lt[:, -1].argmax(-1).numpy()[sure], tok[sure])
        if step == G:
            break
        lj, cj = jdec(tree, cj, jnp.asarray(tok[:, None], jnp.int32))
        lt, ct = tdec(model, ct, torch.from_numpy(tok[:, None]))
    assert ct["index"] == P + G


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    """loss_fn's value, ce and aux, and every parameter's gradient
    against jax.value_and_grad of the reference's loss_fn (the router's
    gradient runs through both packages' float32 softmax)."""
    cfg, jcfg, tree, model = _setup(arch)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 32))
    labels = rng.integers(0, cfg.vocab_size, (2, 32))
    labels[:, :3] = -1
    (want, wmet), wgrad = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jcfg, p, b), has_aux=True))(
        tree, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    loss, met = lm.loss_fn(cfg, model, {"tokens": torch.from_numpy(toks),
                                        "labels": torch.from_numpy(labels)})
    loss.backward()
    assert abs(float(loss) - float(want)) <= ROUTED_TOL * abs(float(want))
    assert abs(float(met["aux"]) - float(wmet["aux"])) <= \
        1e-6 * float(wmet["aux"])
    got = lm_tree_to_jax(model, {n: p.grad
                                 for n, p in model.named_parameters()})
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(wgrad)[0],
                            jax.tree.leaves(got)):
        assert _rel(g, w) <= ROUTED_TOL, jax.tree_util.keystr(path)
