"""The port's LM training slice on the CPU against the JAX package: the
flash_attention backward (`flash_attention_bwd` through
`FlashAttentionFunction`) against `jax.vjp` of the reference's chunked
`flash_attention_jnp`, the plain log-sum-exp against `_flash_fwd_impl`'s,
`cross_entropy`, `loss_fn` and every parameter's gradient with remat off,
full and dots, the train step with Adam (whole batch and 4 microbatches),
Adafactor, the schedules, MarkovLMData, and the train launcher under both
consensus modes with a checkpoint the reference restores.

Inputs are drawn with numpy (or by the reference's own initializer) and
handed to both packages through `lm_params_from_jax`. The model is
internlm2-1.8b reduced with 2 KV heads (2 layers, d 256, 4 heads,
head_dim 64), in float32; the reference runs under jax.jit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jrestore
from repro.configs import get_config as jget_config
from repro.data.lm_data import MarkovLMData as JMarkovLMData
from repro.kernels.flash_jnp import _flash_fwd_impl, flash_attention_jnp
from repro.launch import steps as jsteps
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.optim import adafactor as jadafactor
from repro.optim import adam as jadam
from repro.optim import schedules as jschedules
from repro_torch.configs import get_config
from repro_torch.data import MarkovLMData
from repro_torch.kernels import flash_attention as F
from repro_torch.launch import steps, train
from repro_torch.models import common, lm
from repro_torch.models.convert import lm_params_from_jax, lm_tree_to_jax
from repro_torch.optim import adafactor, adam, schedules

torch.set_num_threads(2)

# the attention backward in float32, as tests/test_kernels.py holds the
# reference's kernels to their oracles
BWD_RTOL, BWD_ATOL = 1e-4, 1e-5
# whole-model float32 loss, relative; each gradient leaf, relative to its
# max |g|: the two packages order their float32 sums differently
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
# post-step parameters: the reference's own microbatch test
# (tests/test_system.py:77), on the entries whose Adam update saturates
STEP_RTOL, STEP_ATOL = 2e-3, 2e-4
LR = 1e-3
B, S = 2, 32

# (B, H, KH, Sq, Sk, D, causal, window, chunk of the port's backward):
# GQA, right-aligned Sq < Sk, a sliding window, not causal, the decode
# shape; chunks that divide Sk and ragged ones (the reference runs its op's
# divisor chunk, here all of Sk)
BWD_CASES = [(2, 4, 2, 64, 64, 32, True, None, 16),
             (1, 4, 1, 48, 80, 16, True, None, 24),
             (1, 4, 2, 64, 64, 16, True, 16, 20),
             (1, 2, 2, 40, 40, 16, False, None, 40),
             (2, 8, 2, 1, 50, 16, True, None, 16)]


def _cfgs(**kw):
    """(reference config, port config) of reduced internlm2-1.8b with 2 KV
    heads."""
    jcfg = jget_config("internlm2-1.8b").reduced().with_overrides(
        num_kv_heads=2, **kw)
    cfg = get_config("internlm2-1.8b").reduced().with_overrides(
        num_kv_heads=2, **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


@pytest.fixture(scope="module")
def jparams():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, jax.jit(
        jlm.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0)))


def _batch(seed=0, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (batch, seq)).astype(np.int32)
    labels = rng.integers(0, 512, (batch, seq)).astype(np.int32)
    labels[0, :3] = -1
    return {"tokens": toks, "labels": labels}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _qkv(b, h, kh, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, sq, d)).astype(np.float32),
            rng.normal(size=(b, kh, sk, d)).astype(np.float32),
            rng.normal(size=(b, kh, sk, d)).astype(np.float32),
            rng.normal(size=(b, h, sq, d)).astype(np.float32))


@pytest.mark.parametrize("b,h,kh,sq,sk,d,causal,window,chunk", BWD_CASES)
def test_flash_backward_matches_reference_vjp(b, h, kh, sq, sk, d, causal,
                                              window, chunk):
    """dq, dk, dv of FlashAttentionFunction (plain forward with lse, the
    ported chunked backward) against jax.vjp of flash_attention_jnp, and
    flash_attention_bwd called directly alike."""
    q, k, v, do = _qkv(b, h, kh, sq, sk, d, sk + chunk)

    @jax.jit
    def ref_vjp(q, k, v, do):
        _, vjp = jax.vjp(
            lambda *a: flash_attention_jnp(*a, causal, window, sk), q, k, v)
        return vjp(do)
    want = [np.asarray(g) for g in ref_vjp(*(jnp.asarray(a)
                                             for a in (q, k, v, do)))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = F.FlashAttentionFunction.apply(tq, tk, tv, causal, window, None,
                                         chunk)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    _, lse = F.flash_attention_plain_lse(tq.detach(), tk.detach(),
                                         tv.detach(), causal, window)
    direct = F.flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(),
                                   lse, torch.from_numpy(do), causal,
                                   window, None, chunk)
    for g, dg, w in zip(got, direct, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=BWD_RTOL,
                                   atol=BWD_ATOL)
        assert torch.equal(g, dg)


@pytest.mark.parametrize("b,h,kh,sq,sk,d,causal,window,chunk", BWD_CASES)
def test_plain_lse_matches_reference(b, h, kh, sq, sk, d, causal, window,
                                     chunk):
    q, k, v, _ = _qkv(b, h, kh, sq, sk, d, sk)
    want_o, want_lse = jax.jit(
        lambda *a: _flash_fwd_impl(*a, causal, window, sk, None))(
            *(jnp.asarray(a) for a in (q, k, v)))
    o, lse = F.flash_attention_plain_lse(
        *(torch.from_numpy(a) for a in (q, k, v)), causal, window)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(o, F.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), causal, window))


@pytest.mark.parametrize("masked", [False, True, "all"])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 7))
    labels[0, :2] = -1
    labels[2, 5] = -4
    mask = None
    if masked:
        mask = rng.integers(0, 2, (3, 7)) if masked is True else \
            np.zeros((3, 7), np.int64)
    want = jax.jit(jcommon.cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = common.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               None if mask is None else
                               torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("remat", [None, "full", "dots"])
def test_loss_and_gradients_match_reference(jparams, remat):
    """The loss, ce, aux and every parameter's gradient against
    jax.value_and_grad(lm.loss_fn) with the same remat setting."""
    over = dict(remat=remat is not None, remat_policy=remat or "full")
    jcfg, cfg = _cfgs(**over)
    batch = _batch()
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, _jbatch(batch)), has_aux=True))(
            jparams)
    model = lm_params_from_jax(cfg, jparams, device="cpu")
    loss, metrics = lm.loss_fn(cfg, model, _tbatch(batch))
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(jl)) <= LOSS_TOL * abs(float(jl))
    assert abs(float(metrics["ce"]) - float(jm["ce"])) <= \
        LOSS_TOL * abs(float(jl))
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    grads = lm_tree_to_jax(model, {n: p.grad
                                   for n, p in model.named_parameters()})
    got, want = _leaves(grads), _leaves(jg)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max()


def test_remat_replays_the_attention_forward(jparams, monkeypatch):
    """Under remat each block's attention forward runs again in the
    backward (2 x layers calls a step), and the gradients are those
    without remat."""
    calls = []
    real = F.flash_attention_lse

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(F, "flash_attention_lse", counted)
    grads = {}
    for remat in (False, True):
        _, cfg = _cfgs(remat=remat)
        model = lm_params_from_jax(cfg, jparams, device="cpu")
        calls.clear()
        loss, _ = lm.loss_fn(cfg, model, _tbatch(_batch(1)))
        loss.backward()
        assert len(calls) == cfg.num_layers * (2 if remat else 1)
        grads[remat] = [p.grad for p in model.parameters()]
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("microbatch", [1, 4])
def test_train_step_matches_reference(jparams, microbatch):
    """One Adam step (lr 1e-3) on a batch of 8, whole or as 4 microbatches,
    against the reference's make_train_step: the loss within LOSS_TOL; the
    parameters at the reference's own microbatch tolerances wherever the
    reference's update is at least lr / 2, and within 2 lr elsewhere.
    Adam's first step is lr g / (|g| + eps): where |g| is near eps (1e-8)
    the float32 rounding of g (a few 1e-9 here, the gradients' order of
    summation) moves the update by a fair part of lr; above lr / 2, |g| >=
    eps and that rounding stays below STEP_ATOL."""
    jcfg, cfg = _cfgs()
    batch = _batch(2, batch=8)
    jopt = jadam(LR)
    jp, _, jl, _ = jax.jit(jsteps.make_train_step(jcfg, jopt, microbatch))(
        jparams, jopt.init(jparams), _jbatch(batch))
    model = lm_params_from_jax(cfg, jparams, device="cpu")
    opt = adam(LR)
    state = opt.init(dict(model.named_parameters()))
    step = steps.make_train_step(cfg, opt, microbatch)
    state, loss, _ = step(model, state, _tbatch(batch))
    assert abs(float(loss) - float(jl)) <= LOSS_TOL * abs(float(jl))
    assert int(state["step"]) == 1
    got = _leaves(lm_tree_to_jax(model, dict(model.named_parameters())))
    saturated = 0
    for g, w, p0 in zip(got, _leaves(jp), _leaves(jparams)):
        sat = np.abs(w - p0) >= LR / 2
        saturated += int(sat.sum())
        np.testing.assert_allclose(g[sat], w[sat], rtol=STEP_RTOL,
                                   atol=STEP_ATOL)
        assert np.abs(g - w).max() <= 2 * LR
    assert saturated > 0.5 * sum(p.size for p in got)


def test_adafactor_matches_reference():
    """3 Adafactor steps with a warm-up-cosine schedule on factored leaves
    (both of the last two dims >= min_dim_factored) and unfactored ones,
    stacked leaves included; float32 statistics."""
    rng = np.random.default_rng(6)
    shapes = {"mat": (160, 130), "stacked": (2, 140, 128), "vec": (130,),
              "thin": (4, 200)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 10 ** (i - 1)
              for k, s in shapes.items()} for i in range(3)]
    jopt = jadafactor(jschedules.warmup_cosine(1e-2, 2, 10))
    opt = adafactor(schedules.warmup_cosine(1e-2, 2, 10))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jopt.init(jp)
    jupdate = jax.jit(jopt.update)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    st = opt.init(tp)
    assert set(st["stats"]["mat"]) == {"vr", "vc"}
    assert set(st["stats"]["stacked"]) == {"vr", "vc"}
    assert set(st["stats"]["vec"]) == set(st["stats"]["thin"]) == {"v"}
    for g in grads:
        ju, jst = jupdate({k: jnp.asarray(v) for k, v in g.items()}, jst,
                          jp)
        jp = {k: jp[k] + ju[k] for k in jp}
        u, st = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                           st, tp)
        tp = {k: tp[k] + u[k] for k in tp}
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        for name, stat in st["stats"][k].items():
            np.testing.assert_allclose(stat.numpy(),
                                       np.asarray(jst["stats"][k][name]),
                                       rtol=1e-5)


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-3,)), ("cosine", (1e-2, 7, 0.2)),
    ("warmup_cosine", (1e-2, 3, 10))])
def test_schedules_match_reference(name, args):
    got = getattr(schedules, name)(*args)
    want = getattr(jschedules, name)(*args)
    for step in (0, 1, 2, 3, 5, 7, 10, 12):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step))),
                                   rtol=1e-12)


@pytest.mark.parametrize("agent", [0, 3])
def test_markov_data_equals_reference(agent):
    mine = MarkovLMData(512, seed=1, agent=agent)
    ref = JMarkovLMData(512, seed=1, agent=agent)
    for shape in ((4, 33), (2, 8)):
        for a, b in zip(mine.batch(*shape), ref.batch(*shape)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("consensus", ["allreduce", "dec_admm"])
def test_train_launcher_on_the_cpu(tmp_path, capsys, consensus):
    """`launch.train --device cpu --reduced` under both consensus modes:
    the reference's report lines, finite losses, no kernel launch on the
    CPU, and a checkpoint of the (agent-mean) parameters that the
    reference's `repro.checkpoint.restore` loads into its own tree."""
    ckpt = str(tmp_path / "ckpt")
    args = train.parse_args(["--arch", "internlm2-1.8b", "--reduced",
                             "--steps", "2", "--batch", "2", "--seq", "16",
                             "--consensus", consensus, "--agents", "2",
                             "--log-every", "1", "--device", "cpu",
                             "--ckpt", ckpt])
    out = train.run(args)
    text = capsys.readouterr().out
    assert "consensus=" + consensus in text and "saved" in text
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["flash_launches"] == [0, 0]
    models = out["models"]
    assert len(models) == (2 if consensus == "dec_admm" else 1)
    if consensus == "dec_admm":
        assert "disagreement" in text and out["disagreement"][-1] > 0
    jcfg = jget_config("internlm2-1.8b").reduced()
    template = jax.eval_shape(lambda: jlm.init_params(
        jcfg, jax.random.PRNGKey(0)))
    restored = jrestore(ckpt, template)
    mean = {n: torch.stack([dict(m.named_parameters())[n].detach()
                            for m in models]).mean(0)
            for n, _ in models[0].named_parameters()}
    for a, b in zip(_leaves(restored),
                    _leaves(lm_tree_to_jax(models[0], mean))):
        np.testing.assert_array_equal(a, b)
