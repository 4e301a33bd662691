"""The port's whisper encoder-decoder on the CPU against the JAX package:
whisper-small reduced (2 encoder and 2 decoder layers, d 256, 32 frames)
through `encode` (non-causal self-attention, learned positions),
`decode` with a prompt longer than the frames (the cross-attention's
Sq > Sk, no mask) and at positions past max_seq (clipped), prefill +
greedy decode (`launch.steps`: the encoder states carried to every
step), `loss_fn` and every parameter's gradient, the parameter layout
round trip, and the serve and train launchers.

Weights come from the reference's own initializer in float64, handed
over through `models.convert`; frames and tokens are drawn with numpy.
Both packages' flash attention computes in float32 whatever the model's
dtype, so the outputs and gradients agree to float32 rounding
(ATTN_TOL), not float64's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.models import encdec as jencdec
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as F
from repro_torch.launch import serve, steps, train
from repro_torch.models import EncDec, encdec
from repro_torch.models.convert import (lm_params_from_jax,
                                        lm_params_to_jax, lm_tree_to_jax)

torch.set_num_threads(2)

ARCH = "whisper-small"
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
        lambda key: jencdec.init_params(jcfg, key, jnp.float64))(
            jax.random.PRNGKey(0)))


def _setup():
    cfg = get_config(ARCH).reduced()
    tree = _tree()
    return (cfg, jget_config(ARCH).reduced(), tree,
            lm_params_from_jax(cfg, tree, device="cpu"))


def _frames(cfg, seed):
    return 0.1 * np.random.default_rng(seed).normal(
        size=(2, cfg.enc_seq, cfg.d_model))


def test_params_round_trip():
    cfg, _, tree, model = _setup()
    assert isinstance(model, EncDec)
    assert (cfg.enc_seq, cfg.enc_layers, cfg.num_layers) == (32, 2, 2)
    back = lm_params_to_jax(model)
    flat, treedef = jax.tree.flatten(tree)
    flat2, treedef2 = jax.tree.flatten(back)
    assert treedef == treedef2
    for a, b in zip(flat, flat2):
        assert a.shape == b.shape and np.array_equal(a, b)
    assert encdec.param_count(cfg) == sum(p.numel()
                                          for p in model.parameters())
    assert encdec.param_count(get_config(ARCH)) == 310_502_400


@pytest.mark.parametrize("offset", [0, 240])
def test_encode_and_decode_match_reference(offset):
    """The encoder states, then decoder logits for 48 tokens against the
    32 frames (cross-attention with Sq > Sk), at positions from 0 and from
    240 (past max_seq = 256, where pos_dec's index is clipped)."""
    cfg, jcfg, tree, model = _setup()
    frames = _frames(cfg, 1)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 48))
    pos = np.broadcast_to(offset + np.arange(48), (2, 48))
    enc_ref = jax.jit(lambda p, f: jencdec.encode(jcfg, p, f))(
        tree, jnp.asarray(frames))
    want, _ = jax.jit(lambda p, t, e, q: jencdec.decode(
        jcfg, p, t, e, positions=q))(tree, jnp.asarray(toks), enc_ref,
                                     jnp.asarray(pos))
    with torch.no_grad():
        enc = model.encode(torch.from_numpy(frames))
        got, cache = model.decode(torch.from_numpy(toks), enc,
                                  positions=torch.from_numpy(pos.copy()))
    assert cache is None
    assert _rel(enc, enc_ref) <= ATTN_TOL
    assert _rel(got, want) <= ATTN_TOL


def test_prefill_and_greedy_decode_match_reference_steps():
    """Prefill (frames encoded, a 40-token prompt) + 6 greedy decode
    steps through the reference's steps and the port's, the encoder
    states carried to each step."""
    cfg, jcfg, tree, model = _setup()
    P, G = 40, 6
    frames = _frames(cfg, 3)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, P))
    jpre = jax.jit(jsteps.make_prefill_step(jcfg, max_len=P + G + 1))
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    lj, cj, ej = jpre(tree, jnp.asarray(frames), jnp.asarray(toks, jnp.int32))
    lt, ct, et = steps.make_prefill_step(cfg, P + G + 1)(
        model, torch.from_numpy(frames), torch.from_numpy(toks))
    assert _rel(et, ej) <= ATTN_TOL
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
        lj, cj = jdec(tree, cj, ej, jnp.asarray(tok[:, None], jnp.int32))
        lt, ct = tdec(model, ct, et, torch.from_numpy(tok[:, None]))
    assert ct["index"] == P + G


def test_loss_and_gradients_match_reference():
    cfg, jcfg, tree, model = _setup()
    rng = np.random.default_rng(5)
    batch = {"frames": _frames(cfg, 6),
             "tokens": rng.integers(0, cfg.vocab_size, (2, 40)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 40))}
    (want, _), wgrad = jax.jit(jax.value_and_grad(
        lambda p, b: jencdec.loss_fn(jcfg, p, b), has_aux=True))(
        tree, jax.tree.map(jnp.asarray, batch))
    loss, met = encdec.loss_fn(cfg, model, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    loss.backward()
    assert float(met["aux"]) == 0.0
    assert abs(float(loss) - float(want)) <= ATTN_TOL * abs(float(want))
    got = lm_tree_to_jax(model, {n: p.grad
                                 for n, p in model.named_parameters()})
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(wgrad)[0],
                            jax.tree.leaves(got)):
        assert _rel(g, w) <= ATTN_TOL, jax.tree_util.keystr(path)


def test_launchers_carry_the_frames(capsys):
    """serve draws frames from the run's generator and carries the
    encoder states to every decode step (a prompt longer than the 32
    frames); train's batches carry frames and take one step under
    allreduce and under DEC-ADMM."""
    cfg = get_config(ARCH).reduced()
    F.reset_launches()
    out = serve.run(serve.parse_args(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
         "--prompt-len", "40", "--gen", "3"]))
    assert out["frames"].shape == (2, cfg.enc_seq, cfg.d_model)
    assert out["embeds"] is None and out["tokens"].shape == (2, 3)
    assert F.launches == 0
    text = capsys.readouterr().out
    assert "(6 attention layers)" in text
    for extra in ([], ["--consensus", "dec_admm", "--agents", "2"]):
        res = train.run(train.parse_args(
            ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "1",
             "--batch", "2", "--seq", "40"] + extra))
        assert np.isfinite(res["losses"][0])
        assert isinstance(res["models"][0], EncDec)
