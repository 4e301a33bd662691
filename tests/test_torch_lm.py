"""The port's LM serving slice on the CPU against the JAX package: the
flash_attention kernel module (plain version and op) against the
reference's Pallas kernel in interpret mode and its oracle, the model
components, the attention module with and without a cache, the parameter
conversion, whole-model logits with the reference's attention on its
chunked path and on the Pallas kernel, prefill + greedy decode against
the reference's serving steps, and the serve launcher.

Inputs are drawn with numpy and handed to both packages. The reference
runs at internlm2-1.8b reduced with 2 KV heads (2 layers, d 256, 4 heads,
head_dim 64), so GQA is exercised. The CUDA kernel runs only on a card:
tests/test_torch_gpu.py holds it to the plain version there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_jnp import flash_attention_jnp
from repro.launch.steps import make_decode_step, make_prefill_step
from repro.models import attention as jattention
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import flash_attention as F
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve, steps
from repro_torch.models import LM, attention, common
from repro_torch.models.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.models.lm import param_count

torch.set_num_threads(2)

# float32 attention against the Pallas kernel, as tests/test_kernels.py
# holds the kernel to its oracle; bf16 outputs round to 2^-8 relative
F32_TOL, BF16_TOL = 2e-5, 2e-2
# whole-model float32 logits, max |error| relative to max |logit|: the two
# packages order their float32 sums differently (measured about 7e-7)
LOGIT_TOL = 1e-5
# the shapes of tests/test_kernels.py:44-50
SHAPES = [(2, 4, 2, 128, 128, 64, True, None),
          (1, 8, 8, 256, 256, 64, False, None),
          (2, 4, 4, 1, 512, 64, True, None),          # decode shape
          (1, 4, 2, 128, 512, 64, True, 64),          # sliding window
          (1, 2, 1, 96, 96, 32, True, None),
          (1, 4, 1, 64, 64, 128, True, None)]         # max GQA ratio


def _cfg():
    return jget_config("internlm2-1.8b").reduced().with_overrides(
        num_kv_heads=2)


def _qkv(b, h, kh, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, sq, d)).astype(np.float32),
            rng.normal(size=(b, kh, sk, d)).astype(np.float32),
            rng.normal(size=(b, kh, sk, d)).astype(np.float32))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,sq,sk,d,causal,window", SHAPES)
def test_flash_attention_matches_pallas_interpret(b, h, kh, sq, sk, d,
                                                  causal, window, dtype):
    """The plain version and the op on the CPU against the reference's
    Pallas kernel (interpret mode, 64 x 64 blocks), on the same inputs."""
    q, k, v = _qkv(b, h, kh, sq, sk, d)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jops.flash_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), causal=causal,
        window=window, use_pallas=True, interpret=True, bq=64, bk=64)
    want = np.asarray(want.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for got in (F.flash_attention_plain(tq, tk, tv, causal, window),
                ops.flash_attention(tq, tk, tv, causal=causal,
                                    window=window)):
        assert got.dtype == tdt and got.shape == (b, h, sq, d)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("b,h,kh,sq,sk,d,causal,window", SHAPES + [
    (1, 4, 2, 1000, 1000, 64, True, None),        # ragged
    (1, 4, 2, 77, 203, 32, True, 50),             # ragged, window
    (1, 2, 2, 30, 45, 64, False, 7)])             # window, not causal
def test_flash_attention_oracles_agree(b, h, kh, sq, sk, d, causal, window):
    """The port's oracle (repeated k/v, float32) against the reference's,
    and the plain version (grouped heads) against the port's oracle, at
    the six shapes and at ragged ones the reference's op never hands its
    kernel. float64 inputs: the three agree to rounding."""
    q, k, v = (a.astype(np.float64) for a in _qkv(b, h, kh, sq, sk, d, 1))
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    own = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert own.dtype == torch.float64
    # the port's oracle computes in float32, the reference's in float64
    assert _rel(own, want) <= 1e-5
    plain = F.flash_attention_plain(tq.float(), tk.float(), tv.float(),
                                    causal, window)
    assert _rel(plain, own.float()) <= 1e-6


@pytest.mark.parametrize("bad,match", [
    ("sq>sk", "no admitted key"), ("gqa", "multiple of KH"),
    ("window", "window"), ("shape", "want q")])
def test_flash_attention_plain_refuses_bad_shapes(bad, match):
    q, k, v = (torch.zeros(1, 4, 8, 32), torch.zeros(1, 2, 8, 32),
               torch.zeros(1, 2, 8, 32))
    window = None
    if bad == "sq>sk":
        q = torch.zeros(1, 4, 9, 32)
    elif bad == "gqa":
        k, v = torch.zeros(1, 3, 8, 32), torch.zeros(1, 3, 8, 32)
    elif bad == "window":
        window = 0
    elif bad == "shape":
        v = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match=match):
        F.flash_attention_plain(q, k, v, True, window)
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, v, window=window)


@pytest.mark.parametrize("b,h,kh,sq,sk,d,chunk", [
    (2, 4, 4, 96, 40, 64, 16),        # whisper's cross-attention, MHA
    (1, 6, 1, 70, 48, 32, 48)])       # GQA 6, one chunk
def test_noncausal_attention_with_more_queries_than_keys(b, h, kh, sq, sk,
                                                         d, chunk):
    """Sq > Sk without a mask (the whisper decoder's cross-attention over
    a prompt longer than its frames): every query admits every key. The
    plain version, the op, the kernel's split-TF32 arithmetic and the
    Function's gradients (its chunked backward, ragged chunks at 16)
    against the reference's flash_attention_jnp and its jax.vjp (a chunk
    of Sk, which its op hands it); causal or windowed, the shape is still
    refused."""
    q, k, v = _qkv(b, h, kh, sq, sk, d, 8)
    do = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)

    @jax.jit
    def ref(q, k, v, do):
        out, vjp = jax.vjp(
            lambda *a: flash_attention_jnp(*a, False, None, sk), q, k, v)
        return out, vjp(do)
    want, want_grads = ref(*(jnp.asarray(a) for a in (q, k, v, do)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for got in (F.flash_attention_plain(tq, tk, tv, False),
                ops.flash_attention(tq, tk, tv, causal=False),
                F.flash_attention_split_tf32(tq, tk, tv, False)):
        assert got.shape == (b, h, sq, d)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_TOL, atol=F32_TOL)
    qkv = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = F.FlashAttentionFunction.apply(*qkv, False, None, None, chunk)
    grads = torch.autograd.grad(out, qkv, torch.from_numpy(do))
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    for causal, window in ((True, None), (False, 8)):
        with pytest.raises(ValueError, match="no admitted key"):
            F.flash_attention_plain(tq, tk, tv, causal, window)


def test_flash_attention_first_blocks_masked_are_finite():
    """A sliding window whose first key blocks are wholly masked for the
    late queries: finite output, equal to attention over the admitted
    keys alone."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 256, 256, 32, 2))
    got = F.flash_attention_plain(q, k, v, True, 16)
    assert bool(torch.isfinite(got).all())
    last = torch.softmax(q[:, :, -1:] @ k[:, :, -16:].transpose(-1, -2)
                         / 32 ** 0.5, -1) @ v[:, :, -16:]
    assert float((got[:, :, -1:] - last).abs().max()) <= 1e-6


def test_rmsnorm_rope_mlps_match_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 4, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        common.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)
    pos = rng.integers(0, 2048, size=(2, 5))
    for frac in (1.0, 0.5):
        cos, sin, rot = common.rope_freqs(64, torch.from_numpy(pos), 1e6,
                                          frac)
        jcos, jsin, jrot = jcommon.rope_freqs(64, jnp.asarray(pos), 1e6,
                                              frac)
        assert rot == jrot
        np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=2e-6)
        got = common.apply_rope(torch.from_numpy(x), cos, sin, rot)
        want = jcommon.apply_rope(jnp.asarray(x), jcos, jsin, jrot)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    xs = rng.normal(size=(3, 32)).astype(np.float32)
    wg, wu = (rng.normal(size=(32, 48)).astype(np.float32) for _ in "gu")
    wd = rng.normal(size=(48, 32)).astype(np.float32)
    got = common.swiglu(*(torch.from_numpy(a) for a in (xs, wg, wu, wd)))
    want = jcommon.swiglu(*(jnp.asarray(a) for a in (xs, wg, wu, wd)))
    assert _rel(got.numpy(), want) <= 1e-6
    got = common.gelu_mlp(*(torch.from_numpy(a) for a in (xs, wg, wd)))
    want = jcommon.gelu_mlp(*(jnp.asarray(a) for a in (xs, wg, wd)))
    assert _rel(got.numpy(), want) <= 1e-6


def _jax_params(cfg, seed=0):
    return jlm.init_params(cfg, jax.random.PRNGKey(seed))


def _port_model(cfg, params):
    return lm_params_from_jax(cfg, jax.tree.map(np.asarray, params),
                              device="cpu")


@pytest.mark.parametrize("cached", [False, True])
def test_attention_module_matches_reference(cached):
    """One attention layer with the reference's weights: a forward pass
    without a cache, or a prefill into a cache and one decode step."""
    cfg = _cfg()
    params = _jax_params(cfg)
    p = jax.tree.map(lambda t: t[0, 0], params["blocks"]["dense"]["attn"])
    model = _port_model(cfg, params)
    attn = model.blocks[0].attn
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(24), (2, 1))
    if not cached:
        want, _ = jattention.attention(p, jnp.asarray(x), cfg,
                                       positions=jnp.asarray(pos))
        got, cache = attn(torch.from_numpy(x), torch.from_numpy(pos))
        assert cache is None
        assert _rel(got.detach(), want) <= 1e-5
        return
    jc = jattention.init_cache(cfg, 2, 32, jnp.float32)
    tc = attention.init_cache(cfg, 2, 32)
    for sl in (slice(0, 23), slice(23, 24)):
        want, jc = jattention.attention(
            p, jnp.asarray(x[:, sl]), cfg, positions=jnp.asarray(pos[:, sl]),
            cache=jc)
        got, tc = attn(torch.from_numpy(x[:, sl]),
                       torch.from_numpy(pos[:, sl]), tc)
        assert _rel(got.detach(), want) <= 1e-5
        assert tc["index"] == int(jc["index"])
    np.testing.assert_allclose(tc["k"].detach().numpy(), np.asarray(jc["k"]),
                               rtol=1e-5, atol=1e-5)


def test_params_round_trip_and_port_init():
    """Reference tree -> LM -> tree is exact; the port's own initializer
    draws the reference's scales; the port's draw runs in the reference's
    forward and gives the port's logits."""
    cfg = _cfg()
    tree = jax.tree.map(np.asarray, _jax_params(cfg))
    back = lm_params_to_jax(lm_params_from_jax(cfg, tree, device="cpu"))
    flat, treedef = jax.tree.flatten(tree)
    flat2, treedef2 = jax.tree.flatten(back)
    assert treedef == treedef2
    for a, b in zip(flat, flat2):
        assert a.shape == b.shape and np.array_equal(a, b)

    big = get_config("internlm2-1.8b").reduced(d_model=512)
    model = LM(big, device="cpu", generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == param_count(big)
    blk = model.blocks[0]
    for w, want in ((model.embed, 0.02), (blk.attn.wq, 512 ** -0.5),
                    (blk.attn.wo, big.num_heads ** -0.5),
                    (blk.mlp.wd, big.d_ff ** -0.5),
                    (model.lm_head, 512 ** -0.5)):
        assert abs(float(w.detach().std()) / want - 1) < 0.05
        assert abs(float(w.detach().mean())) < 0.05 * want
    assert bool((blk.ln1.weight == 1).all())

    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 16))
    want, _, _ = jlm.forward(cfg, jax.tree.map(jnp.asarray,
                                               lm_params_to_jax(model)),
                             jnp.asarray(toks))
    got, _, _ = model(torch.from_numpy(toks))
    assert _rel(got.detach(), want) <= LOGIT_TOL


def test_full_config_has_the_published_size():
    cfg = get_config("internlm2-1.8b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.rope_theta) == (24, 2048, 16, 8, 128, 8192, 92544, 1e6)
    assert param_count(cfg) == 1_889_110_016
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))
        assert dataclasses.asdict(get_config(arch).reduced()) == \
            dataclasses.asdict(jget_config(arch).reduced())


@pytest.mark.parametrize("use_pallas", [False, True])
def test_logits_match_reference_forward(use_pallas):
    """Whole-model float32 logits against the reference's lm.forward with
    its attention on the chunked jnp path and on the Pallas kernel
    (interpret mode); the port ignores use_pallas."""
    cfg = _cfg().with_overrides(use_pallas=use_pallas)
    params = _jax_params(cfg)
    model = _port_model(cfg, params)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 64))
    want, _, _ = jlm.forward(cfg, params, jnp.asarray(toks))
    got, aux, cache = model(torch.from_numpy(toks))
    assert cache is None and float(aux) == 0.0
    assert got.shape == (2, 64, cfg.vocab_size)
    assert _rel(got.detach(), want) <= LOGIT_TOL


def test_prefill_and_greedy_decode_match_reference_steps():
    """Prefill + 8 greedy decode steps through the reference's
    make_prefill_step / make_decode_step and the port's, the reference's
    tokens fed to both: logits within LOGIT_TOL every step, and the port's
    greedy token equal wherever the reference's top-2 gap exceeds that
    tolerance."""
    cfg = _cfg()
    params = _jax_params(cfg)
    model = _port_model(cfg, params)
    P, G = 32, 8
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, P))
    jpre = jax.jit(make_prefill_step(cfg, max_len=P + G + 1))
    jdec = jax.jit(make_decode_step(cfg))
    tpre = steps.make_prefill_step(cfg, max_len=P + G + 1)
    tdec = steps.make_decode_step(cfg)
    lj, cj = jpre(params, jnp.asarray(toks, jnp.int32))
    lt, ct = tpre(model, torch.from_numpy(toks))
    for step in range(G + 1):
        lj_ = np.asarray(lj)[:, -1]
        assert _rel(lt[:, -1], lj_) <= LOGIT_TOL, step
        top2 = np.sort(lj_, -1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) > LOGIT_TOL * np.abs(lj_).max()
        tok = lj_.argmax(-1)
        assert np.array_equal(lt[:, -1].argmax(-1).numpy()[sure], tok[sure])
        if step == G:
            break
        lj, cj = jdec(params, cj, jnp.asarray(tok[:, None], jnp.int32))
        lt, ct = tdec(model, ct, torch.from_numpy(tok[:, None]))
    assert ct["index"] == int(cj["index"]) == P + G


def test_decode_matches_parallel_forward():
    """Prefill + one decode step equals the parallel forward over P + 1
    tokens (the reference's test_smoke_decode_matches_parallel)."""
    cfg = get_config("internlm2-1.8b").reduced()
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=torch.Generator().manual_seed(3))
    _, cache = steps.make_prefill_step(cfg, 36)(model, toks)
    ld, _ = steps.make_decode_step(cfg)(model, cache, toks[:, :1])
    with torch.no_grad():
        lf, _, _ = model(torch.cat([toks, toks[:, :1]], 1), logits_slice=1)
    assert float((ld[:, -1] - lf[:, -1]).abs().max()) < 5e-4


def test_serve_launcher_on_the_cpu(capsys):
    out = serve.run(serve.parse_args(
        ["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu",
         "--batch", "2", "--prompt-len", "16", "--gen", "4"]))
    text = capsys.readouterr().out
    assert "internlm2-1.8b-smoke: prefill 2x16" in text
    assert "tok/s" in text and "sample generations" in text
    assert out["tokens"].shape == (2, 4)
    assert out["prefill_launches"] == out["decode_launches"] == 0
    # sampling at a temperature draws from the seeded generator
    serve.main(["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu",
                "--batch", "1", "--prompt-len", "8", "--gen", "2",
                "--temperature", "0.7"])
    assert "decoded 2 tokens/seq" in capsys.readouterr().out
