"""The port's jamba hybrid on the CPU against the JAX package:
`mamba_layer` (chunked prefill, the one-chunk rule for a ragged length,
decode steps from its state), and jamba-v0.1-52b reduced to 4 layers (one
superblock: attention + dense MLP, two mamba + MoE layers, one mamba
layer) through `forward`, prefill + greedy decode (`launch.steps`),
`loss_fn` and every parameter's gradient, and the parameter layout round
trip.

Weights come from the reference's own initializer in float64, handed
over through `models.convert`; inputs are drawn with numpy. The
reference scans each chunk in float32 (its `.astype(jnp.float32)`) with
`jax.lax.associative_scan`; the port scans in float32 too, with a
log-step scan that associates the same combine in another order. The
scan's states and outputs therefore agree to float32 rounding, and with
the router's float32 logits and the float32 attention, so do the model's
logits and gradients: SCAN_TOL, a float32-level bound.
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
from repro.models import mamba as jmamba
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models import lm, mamba
from repro_torch.models.convert import (lm_params_from_jax,
                                        lm_params_to_jax, lm_tree_to_jax)

torch.set_num_threads(2)

ARCH = "jamba-v0.1-52b"
# max |error| relative to max |reference value|: float32 scans summed in
# another association order (a few float32 ulps a step, over 16-token
# chunks) carried through float64 products; measured below 1e-6
SCAN_TOL = 1e-5
# what the reference computes in the input's dtype (float64 products
# summed in another order)
F64_TOL = 1e-9


def _rel(got, want):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@functools.cache
def _tree():
    """The reference's float64 parameters, drawn once a session by its own
    initializer (jitted)."""
    jcfg = jget_config(ARCH).reduced(layers=4)
    return jax.tree.map(np.asarray, jax.jit(
        lambda key: jlm.init_params(jcfg, key, jnp.float64))(
            jax.random.PRNGKey(0)))


def _setup():
    """(cfg, reference cfg, reference tree, a fresh port model of it)."""
    cfg = get_config(ARCH).reduced(layers=4)
    tree = _tree()
    return (cfg, jget_config(ARCH).reduced(layers=4), tree,
            lm_params_from_jax(cfg, tree, device="cpu"))


@pytest.mark.parametrize("S", [32, 20])
def test_mamba_layer_prefill_and_decode(S):
    """A prefill of S tokens (two 16-token chunks at 32; one chunk of 20,
    the reference's rule for a length the chunk does not divide), then
    two decode steps from its state: outputs and states."""
    cfg, jcfg, tree, model = _setup()
    p = jax.tree.map(lambda t: jnp.asarray(t[0, 1]),
                     tree["blocks"]["mamba_moe"]["mamba"])
    layer = model.blocks[2].mamba
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, S + 2, cfg.d_model))
    ref = jax.jit(lambda p, x, st: jmamba.mamba_layer(p, x, jcfg, state=st))
    want, jstate = ref(p, jnp.asarray(x[:, :S]), None)
    got, state = mamba.mamba_layer(layer, torch.from_numpy(x[:, :S]), cfg)
    assert got.dtype == torch.float64 and state["h"].dtype == torch.float32
    assert _rel(got, want) <= SCAN_TOL
    # the conv state is in_proj's float64 output: float64 rounding only
    assert _rel(state["conv"], jstate["conv"]) <= F64_TOL
    assert _rel(state["h"], jstate["h"]) <= SCAN_TOL
    for t in (S, S + 1):
        want, jstate = ref(p, jnp.asarray(x[:, t:t + 1]), jstate)
        got, state = mamba.mamba_layer(layer, torch.from_numpy(x[:, t:t + 1]),
                                       cfg, state=state)
        # the decode step runs in dt's promoted dtype, float64 here
        assert state["h"].dtype == torch.float64 == got.dtype
        assert _rel(got, want) <= SCAN_TOL
        assert _rel(state["h"], jstate["h"]) <= SCAN_TOL


def test_params_round_trip():
    cfg, _, tree, model = _setup()
    back = lm_params_to_jax(model)
    flat, treedef = jax.tree.flatten(tree)
    flat2, treedef2 = jax.tree.flatten(back)
    assert treedef == treedef2
    for a, b in zip(flat, flat2):
        assert a.shape == b.shape and np.array_equal(a, b)
    assert [kind for kind, *_ in model.plan] == \
        ["attn", "mamba_moe", "mamba_moe", "mamba"]
    assert set(tree["blocks"]) == {"attn", "mamba_moe", "mamba_dense"}
    assert lm.param_count(cfg) == sum(p.numel() for p in model.parameters())


def test_forward_matches_reference():
    cfg, jcfg, tree, model = _setup()
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 48))
    want, want_aux, _ = jax.jit(lambda p, t: jlm.forward(jcfg, p, t))(
        tree, jnp.asarray(toks))
    got, aux, _ = model(torch.from_numpy(toks))
    assert _rel(got, want) <= SCAN_TOL
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * float(want_aux)


def test_prefill_and_greedy_decode_match_reference_steps():
    """Prefill (two chunks) + 6 greedy decode steps through the
    reference's steps and the port's: every step's logits, the caches'
    index, and the greedy pick wherever the reference's top-2 gap exceeds
    the tolerance."""
    cfg, jcfg, tree, model = _setup()
    P, G = 32, 6
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, P))
    jpre = jax.jit(jsteps.make_prefill_step(jcfg, max_len=P + G + 1))
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    lj, cj = jpre(tree, jnp.asarray(toks, jnp.int32))
    lt, ct = steps.make_prefill_step(cfg, P + G + 1)(
        model, torch.from_numpy(toks))
    tdec = steps.make_decode_step(cfg)
    for step in range(G + 1):
        lj_ = np.asarray(lj)[:, -1]
        assert _rel(lt[:, -1], lj_) <= SCAN_TOL, step
        top2 = np.sort(lj_, -1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > SCAN_TOL * np.abs(lj_).max()
        tok = lj_.argmax(-1)
        assert np.array_equal(lt[:, -1].argmax(-1).numpy()[sure], tok[sure])
        if step == G:
            break
        lj, cj = jdec(tree, cj, jnp.asarray(tok[:, None], jnp.int32))
        lt, ct = tdec(model, ct, torch.from_numpy(tok[:, None]))
    assert ct["index"] == P + G == int(cj["index"])
    # the mamba states after the decode steps
    h_ref = np.asarray(cj["blocks"]["mamba_dense"]["h"])[0, 0]
    assert _rel(ct["layers"][3]["h"], h_ref) <= SCAN_TOL


def test_decode_matches_parallel_forward():
    """Prefill + one decode step equals the parallel forward over P + 1
    tokens, a float64 model of the port's own draw; the prefill (21
    tokens) and the forward (22) each scan one ragged chunk. Decode is
    drop-free by the reference's rule while the parallel forward's groups
    drop choices at the configured capacity factor, so the factor is
    raised to E / k: the capacity becomes the group size, and no choice
    drops on either side."""
    base = get_config(ARCH).reduced(layers=4)
    cfg = base.with_overrides(
        moe_capacity_factor=base.num_experts / base.experts_per_token)
    model = lm.LM(cfg, device="cpu", dtype=torch.float64,
                  generator=torch.Generator().manual_seed(2))
    toks = torch.randint(0, cfg.vocab_size, (2, 21),
                         generator=torch.Generator().manual_seed(3))
    _, cache = steps.make_prefill_step(cfg, 24)(model, toks)
    ld, _ = steps.make_decode_step(cfg)(model, cache, toks[:, :1])
    with torch.no_grad():
        lf, _, _ = model(torch.cat([toks, toks[:, :1]], 1), logits_slice=1)
    assert _rel(ld[:, -1], lf[:, -1].numpy()) <= SCAN_TOL


def test_loss_and_gradients_match_reference():
    cfg, jcfg, tree, model = _setup()
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 32))
    labels = rng.integers(0, cfg.vocab_size, (2, 32))
    (want, wmet), wgrad = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jcfg, p, b), has_aux=True))(
        tree, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    loss, met = lm.loss_fn(cfg, model, {"tokens": torch.from_numpy(toks),
                                        "labels": torch.from_numpy(labels)})
    loss.backward()
    assert abs(float(loss) - float(want)) <= SCAN_TOL * abs(float(want))
    got = lm_tree_to_jax(model, {n: p.grad
                                 for n, p in model.named_parameters()})
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(wgrad)[0],
                            jax.tree.leaves(got)):
        assert _rel(g, w) <= SCAN_TOL, jax.tree_util.keystr(path)
