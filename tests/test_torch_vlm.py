"""The port's VLM patch prefix on the CPU against the JAX package:
internvl2-76b reduced (2 dense layers, 8 patch embeddings before the
text) through `forward` with `embeds`, prefill with the prefix + greedy
decode (`launch.steps`), `loss_fn` (the prefix's labels padded with -1)
and every parameter's gradient, the parameter layout round trip, and the
serve and train launchers.

Weights come from the reference's own initializer in float64, handed
over through `models.convert`; tokens and patch embeddings are drawn
with numpy. Both packages' flash attention computes in float32 whatever
the model's dtype, so the logits and gradients agree to float32 rounding
(ATTN_TOL), not float64's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.launch import serve, steps, train
from repro_torch.models import lm
from repro_torch.models.convert import (lm_params_from_jax,
                                        lm_params_to_jax, lm_tree_to_jax)

torch.set_num_threads(2)

ARCH = "internvl2-76b"
# max |error| relative to max |reference value|: the float32 attention
# of both packages carried through float64 layers; measured below 1e-6
ATTN_TOL = 1e-5


def _rel(got, want):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@functools.cache
def _tree():
    jcfg = jget_config(ARCH).reduced()
    return jax.tree.map(np.asarray, jax.jit(
        lambda key: jlm.init_params(jcfg, key, jnp.float64))(
            jax.random.PRNGKey(0)))


def _setup():
    cfg = get_config(ARCH).reduced()
    tree = _tree()
    return (cfg, jget_config(ARCH).reduced(), tree,
            lm_params_from_jax(cfg, tree, device="cpu"))


def _inputs(cfg, S, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (2, S)),
            0.1 * rng.normal(size=(2, cfg.vis_tokens, cfg.d_model)))


def test_params_round_trip():
    cfg, _, tree, model = _setup()
    assert cfg.vis_tokens == 8
    back = lm_params_to_jax(model)
    flat, treedef = jax.tree.flatten(tree)
    flat2, treedef2 = jax.tree.flatten(back)
    assert treedef == treedef2
    for a, b in zip(flat, flat2):
        assert a.shape == b.shape and np.array_equal(a, b)
    assert lm.param_count(cfg) == sum(p.numel() for p in model.parameters())


def test_forward_with_the_prefix_matches_reference():
    """Logits over prefix + text (positions over the whole stream)."""
    cfg, jcfg, tree, model = _setup()
    toks, emb = _inputs(cfg, 24, 1)
    want, _, _ = jax.jit(lambda p, t, e: jlm.forward(jcfg, p, t, embeds=e))(
        tree, jnp.asarray(toks), jnp.asarray(emb))
    got, aux, _ = model(torch.from_numpy(toks), embeds=torch.from_numpy(emb))
    assert got.shape == (2, cfg.vis_tokens + 24, cfg.vocab_size)
    assert float(aux) == 0.0
    assert _rel(got, want) <= ATTN_TOL


def test_prefill_and_greedy_decode_match_reference_steps():
    """Prefill of prefix + prompt, then 6 greedy decode steps, through the
    reference's steps and the port's: the cache index counts the prefix."""
    cfg, jcfg, tree, model = _setup()
    P, G = 24, 6
    toks, emb = _inputs(cfg, P, 2)
    max_len = P + G + cfg.vis_tokens + 1
    jpre = jax.jit(jsteps.make_prefill_step(jcfg, max_len=max_len))
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    lj, cj = jpre(tree, jnp.asarray(toks, jnp.int32), jnp.asarray(emb))
    lt, ct = steps.make_prefill_step(cfg, max_len)(
        model, torch.from_numpy(toks), embeds=torch.from_numpy(emb))
    assert ct["index"] == int(cj["index"]) == cfg.vis_tokens + P
    tdec = steps.make_decode_step(cfg)
    for step in range(G + 1):
        lj_ = np.asarray(lj)[:, -1]
        assert _rel(lt[:, -1], lj_) <= ATTN_TOL, step
        top2 = np.sort(lj_, -1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > ATTN_TOL * np.abs(lj_).max()
        tok = lj_.argmax(-1)
        assert np.array_equal(lt[:, -1].argmax(-1).numpy()[sure], tok[sure])
        if step == G:
            break
        lj, cj = jdec(tree, cj, jnp.asarray(tok[:, None], jnp.int32))
        lt, ct = tdec(model, ct, torch.from_numpy(tok[:, None]))


def test_loss_and_gradients_match_reference():
    cfg, jcfg, tree, model = _setup()
    toks, emb = _inputs(cfg, 32, 3)
    labels = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 32))
    batch = {"tokens": toks, "labels": labels, "embeds": emb}
    (want, _), wgrad = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jcfg, p, b), has_aux=True))(
        tree, jax.tree.map(jnp.asarray, batch))
    loss, _ = lm.loss_fn(cfg, model, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    loss.backward()
    assert abs(float(loss) - float(want)) <= ATTN_TOL * abs(float(want))
    got = lm_tree_to_jax(model, {n: p.grad
                                 for n, p in model.named_parameters()})
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(wgrad)[0],
                            jax.tree.leaves(got)):
        assert _rel(g, w) <= ATTN_TOL, jax.tree_util.keystr(path)


def test_launchers_draw_the_prefix(capsys):
    """serve feeds vis_tokens patch embeddings from the run's generator
    (the cache then holds prefix + prompt + generated tokens); train
    lengthens the sequence to vis_tokens + 16 and pads the prefix's
    labels."""
    cfg = get_config(ARCH).reduced()
    out = serve.run(serve.parse_args(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
         "--prompt-len", "12", "--gen", "3"]))
    assert out["embeds"].shape == (2, cfg.vis_tokens, cfg.d_model)
    assert out["frames"] is None and out["tokens"].shape == (2, 3)
    res = train.run(train.parse_args(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "1",
         "--batch", "2", "--seq", "4"]))
    assert res["tokens_per_step"] == 2 * (cfg.vis_tokens + 16)
    assert np.isfinite(res["losses"][0])
    assert "internvl2-76b-smoke" in capsys.readouterr().out
