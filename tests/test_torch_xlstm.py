"""The port's xLSTM on the CPU against the JAX package: `_mlstm_chunk` and
`mlstm_sequential` from a non-empty state, `mlstm_layer` at 32 tokens (two
16-token chunks), 20 (ragged: one chunk) and 1 (a decode step) from the
state of a prefix, `slstm_layer`, and xlstm-350m reduced to 2 layers (one
mLSTM and one sLSTM block) through `forward`, prefill + 2 greedy decode
steps (`launch.steps`) against the reference's parallel forward, and every
parameter's gradient of the train step's loss, handed back through
`models.convert`.

The reference runs xLSTM in float32 only (under x64 a float64 sLSTM
weight makes its scan's carry float64, which `lax.scan` refuses), so both
packages take the same float32 weights, drawn by the reference's own
initializer, and numpy inputs. Both compute every recurrence in float32,
in different association orders (XLA's and PyTorch's einsums and
cumulative sums): F32_TOL, a float32-level bound relative to max |value|.
The reference functions are jitted once per module (`_ref`).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.models import xlstm as jx
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models import lm, xlstm
from repro_torch.models.convert import (lm_params_from_jax,
                                        lm_params_to_jax, lm_tree_to_jax)

torch.set_num_threads(2)

ARCH = "xlstm-350m"
# max |error| relative to max |reference value|: float32 recurrences summed
# in another order (cumsum, cummax and einsums over 16-token chunks, 64-wide
# heads), carried through two blocks and the head
F32_TOL = 1e-5


def _rel(got, want):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _t(a):
    return torch.from_numpy(np.asarray(a))


@functools.cache
def _ref():
    """The reference's config, float32 parameters and jitted functions,
    once a session."""
    jcfg = jget_config(ARCH).reduced()
    tree = jax.tree.map(np.asarray, jax.jit(
        lambda key: jlm.init_params(jcfg, key, jnp.float32))(
            jax.random.PRNGKey(0)))
    fns = {"chunk": jax.jit(jx._mlstm_chunk),
           "seq": jax.jit(jx.mlstm_sequential),
           "mlstm": jax.jit(lambda p, x, st: jx.mlstm_layer(p, x, jcfg,
                                                            state=st)),
           "slstm": jax.jit(lambda p, x, st: jx.slstm_layer(p, x, jcfg,
                                                            state=st)),
           "forward": jax.jit(lambda p, t: jlm.forward(jcfg, p, t)[0]),
           "grad": jax.jit(jax.value_and_grad(
               lambda p, b: jlm.loss_fn(jcfg, p, b)[0]))}
    return jcfg, tree, fns


def _setup():
    """(cfg, reference cfg, reference tree, reference functions, a fresh
    port model of the tree)."""
    cfg = get_config(ARCH).reduced()
    jcfg, tree, fns = _ref()
    return cfg, jcfg, tree, fns, lm_params_from_jax(cfg, tree, device="cpu")


def _state(rng, B, H, hd):
    """A non-empty mLSTM state (float32 numpy)."""
    return {"C": rng.normal(size=(B, H, hd, hd)).astype(np.float32),
            "n": rng.normal(size=(B, H, hd)).astype(np.float32),
            "m": rng.normal(size=(B, H)).astype(np.float32)}


@pytest.mark.parametrize("part", ["chunk", "seq"])
def test_mlstm_chunk_and_sequential_match_reference(part):
    """One 16-token chunk (and the sequential oracle over it) from a
    non-empty state: h and the state."""
    cfg, _, _, fns, _ = _setup()
    B, H, L, hd = 2, cfg.num_heads, 16, cfg.resolved_head_dim
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(B, H, L, hd)).astype(np.float32)
               for _ in range(3))
    lf = np.log(1 / (1 + np.exp(-rng.normal(size=(B, H, L))))) \
        .astype(np.float32)
    li = rng.normal(size=(B, H, L)).astype(np.float32)
    st = _state(rng, B, H, hd)
    fn = xlstm._mlstm_chunk if part == "chunk" else xlstm.mlstm_sequential
    want_h, want_st = fns[part](q, k, v, lf, li, st)
    got_h, got_st = fn(*map(_t, (q, k, v, lf, li)),
                       {n: _t(a) for n, a in st.items()})
    assert got_h.dtype == torch.float32
    assert _rel(got_h, want_h) <= F32_TOL
    for n in ("C", "n", "m"):
        assert _rel(got_st[n], want_st[n]) <= F32_TOL, n


@pytest.mark.parametrize("S", [32, 20, 1])
def test_mlstm_layer_from_a_prefix_state(S):
    """A 16-token prefix, then S more tokens from its state (32: two
    chunks; 20: the one-chunk rule for a length the chunk does not divide;
    1: a decode step): outputs and states."""
    cfg, _, tree, fns, model = _setup()
    p = jax.tree.map(lambda t: jnp.asarray(t[0, 0]),
                     tree["blocks"]["mlstm"]["cell"])
    cell = model.blocks[0].cell
    x = np.random.default_rng(2).normal(size=(2, 16 + S, cfg.d_model)) \
        .astype(np.float32)
    _, jst = fns["mlstm"](p, x[:, :16], None)
    _, st = xlstm.mlstm_layer(cell, _t(x[:, :16]), cfg)
    want, jst = fns["mlstm"](p, x[:, 16:], jst)
    got, st = xlstm.mlstm_layer(cell, _t(x[:, 16:]), cfg, state=st)
    assert got.shape == (2, S, cfg.d_model)
    assert _rel(got, want) <= F32_TOL
    for n in ("C", "n", "m"):
        assert st[n].dtype == torch.float32
        assert _rel(st[n], jst[n]) <= F32_TOL, n


def test_slstm_layer_matches_reference():
    """24 tokens from the zero state, then 3 from its state."""
    cfg, _, tree, fns, model = _setup()
    p = jax.tree.map(lambda t: jnp.asarray(t[0]),
                     tree["blocks"]["slstm"]["cell"])
    cell = model.blocks[1].cell
    x = np.random.default_rng(3).normal(size=(2, 27, cfg.d_model)) \
        .astype(np.float32)
    jst, st = None, None
    for sl in (slice(0, 24), slice(24, 27)):
        want, jst = fns["slstm"](p, x[:, sl], jst)
        got, st = xlstm.slstm_layer(cell, _t(x[:, sl]), cfg, state=st)
        assert _rel(got, want) <= F32_TOL
        for n in ("h", "c", "n", "m"):
            assert _rel(st[n], jst[n]) <= F32_TOL, n


def test_params_round_trip_and_layout():
    cfg, _, tree, _, model = _setup()
    back = lm_params_to_jax(model)
    flat, treedef = jax.tree.flatten(tree)
    flat2, treedef2 = jax.tree.flatten(back)
    assert treedef == treedef2
    for a, b in zip(flat, flat2):
        assert a.shape == b.shape and np.array_equal(a, b)
    assert [kind for kind, *_ in model.plan] == ["mlstm", "slstm"]
    assert lm.param_count(cfg) == sum(p.numel() for p in model.parameters())
    # the full-width layout: 3 groups of 7 mLSTM blocks and one sLSTM
    full = get_config(ARCH)
    plan = lm.layer_plan(full)
    assert [k for k, *_ in plan[:8]] == ["mlstm"] * 7 + ["slstm"]
    assert len(plan) == 24 and plan[-1] == ("slstm", "slstm", 2, None)


def test_forward_prefill_and_decode_match_reference():
    """The parallel forward over 34 tokens (one ragged chunk) against the
    reference's; a 32-token prefill (two chunks) and two greedy decode
    steps against the reference's parallel forward over the same
    tokens."""
    cfg, _, tree, fns, model = _setup()
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 34))
    want = np.asarray(fns["forward"](tree, jnp.asarray(toks, jnp.int32)))
    got, _, _ = model(_t(toks))
    assert _rel(got, want) <= F32_TOL
    lg, cache = steps.make_prefill_step(cfg, 40)(model, _t(toks[:, :32]))
    assert _rel(lg[:, -1], want[:, 31]) <= F32_TOL
    decode = steps.make_decode_step(cfg)
    for t in (32, 33):
        lg, cache = decode(model, cache, _t(toks[:, t:t + 1]))
        assert _rel(lg[:, -1], want[:, t]) <= F32_TOL, t
    assert cache["index"] == 34
    # no KV cache: the state's size does not depend on max_len
    small = lm.init_decode_cache(cfg, 2, 8)
    big = lm.init_decode_cache(cfg, 2, 4096)
    assert [{k: v.shape for k, v in c.items()} for c in small["layers"]] == \
        [{k: v.shape for k, v in c.items()} for c in big["layers"]]


def test_train_step_gradient_matches_reference():
    """The loss and every parameter's gradient of `lm.loss_fn` against
    `jax.value_and_grad` of the reference's, the gradient handed back in
    the reference's layout; then one Adam step through the train step."""
    cfg, _, tree, fns, model = _setup()
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 32))
    labels = rng.integers(0, cfg.vocab_size, (2, 32))
    want_loss, want = fns["grad"](tree, {"tokens": jnp.asarray(toks),
                                         "labels": jnp.asarray(labels)})
    batch = {"tokens": _t(toks), "labels": _t(labels)}
    loss, _ = lm.loss_fn(cfg, model, batch)
    loss.backward()
    got = lm_tree_to_jax(model, {n: p.grad for n, p in
                                 model.named_parameters()})
    assert abs(float(loss.detach()) - float(want_loss)) <= \
        F32_TOL * abs(float(want_loss))
    flat, treedef = jax.tree.flatten(want)
    flat2, treedef2 = jax.tree.flatten(got)
    assert treedef == treedef2
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for key in path:
            g = g[key.key]
        assert _rel(g, w) <= F32_TOL, jax.tree_util.keystr(path)
    model.zero_grad(set_to_none=True)
    optimizer, _ = steps.pick_optimizer(cfg, 1e-3)
    state = optimizer.init(dict(model.named_parameters()))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, step_loss, _ = steps.make_train_step(cfg, optimizer)(model, state,
                                                            batch)
    assert abs(float(step_loss) - float(loss.detach())) <= \
        1e-6 * float(loss.detach())
    assert all(not torch.equal(p, before[n])
               for n, p in model.named_parameters())
