"""The flash_attention kernel's split-TF32 arithmetic on the CPU.

The CUDA kernel (src/repro_torch/kernels/csrc/flash_attention.cu) runs
both products on the tensor cores from TF32 operands: a float32 x splits
into hi = tf32_rna(x) and lo = tf32_rna(x - hi), and a product is
lo hi' + hi lo' + hi hi'. The kernel module repeats that arithmetic in
plain PyTorch (`tf32_rna`, `split_tf32`, `flash_attention_split_tf32`:
64-key tiles, the kernel's key order, exp2 of the scaled scores); here it
is held to a float64 attention and to the reference's Pallas kernel in
interpret mode, on inputs drawn with numpy, within FLASH_TOL of max |o|,
the tolerance the card's tests hold the kernel to. Measured at SHAPES:
three passes 2.9e-7 to 7.9e-7 of max |o| against float64 (the float32
plain version 2.9e-7 to 7.6e-7) and 2.9e-7 to 1.4e-6 against the
reference's kernel; one pass 3.9e-4 to 5.4e-4, outside the tolerance, so
the three passes are needed. The tensor cores' own order of summation is
not emulated: the card's tests measure that.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as F

torch.set_num_threads(2)

# max |error| relative to max |o| in float32 (tests/test_torch_gpu.py,
# chip_smoke.py)
FLASH_TOL = 2e-5
# (B, H, KH, Sq, Sk, D, causal, window): GQA causal; Sq < Sk at D = 128
# with four query heads a KV head; a window that masks whole leading key
# tiles; not causal over a ragged last tile (96 keys)
SHAPES = [(2, 4, 2, 128, 128, 64, True, None),
          (1, 4, 1, 128, 256, 128, True, None),
          (1, 4, 2, 128, 512, 64, True, 64),
          (1, 2, 2, 96, 96, 32, False, None)]


def _qkv(b, h, kh, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, sq, d)).astype(np.float32),
            rng.normal(size=(b, kh, sk, d)).astype(np.float32),
            rng.normal(size=(b, kh, sk, d)).astype(np.float32))


def _float64_attention(q, k, v, causal, window):
    B, H, Sq, D = q.shape
    g = H // k.shape[1]
    kk = torch.from_numpy(k).double().repeat_interleave(g, 1)
    vv = torch.from_numpy(v).double().repeat_interleave(g, 1)
    s = torch.from_numpy(q).double() @ kk.transpose(-1, -2) * D ** -0.5
    s = s.masked_fill(~F.mask(Sq, k.shape[2], causal, window), float("-inf"))
    return torch.softmax(s, -1) @ vv


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("b,h,kh,sq,sk,d,causal,window", SHAPES)
def test_three_passes_hold_the_float32_tolerance(b, h, kh, sq, sk, d,
                                                 causal, window):
    """Three split-TF32 passes within FLASH_TOL of max |o| of a float64
    attention and of the reference's Pallas kernel (interpret mode)."""
    q, k, v = _qkv(b, h, kh, sq, sk, d)
    got = F.flash_attention_split_tf32(
        *(torch.from_numpy(a) for a in (q, k, v)), causal, window)
    assert got.dtype == torch.float32 and got.shape == (b, h, sq, d)
    assert _rel(got, _float64_attention(q, k, v, causal, window)) \
        <= FLASH_TOL
    want = jops.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal, window=window,
        use_pallas=True, interpret=True, bq=64, bk=64)
    assert _rel(got, want) <= FLASH_TOL


def test_one_tf32_pass_misses_the_float32_tolerance():
    """Plain TF32 (hi hi' alone, both products) keeps about 3 digits:
    measured 3.4e-4 of max |o| here, outside FLASH_TOL."""
    q, k, v = _qkv(1, 4, 2, 256, 256, 128)
    got = F.flash_attention_split_tf32(
        *(torch.from_numpy(a) for a in (q, k, v)), True, None, passes=1)
    assert _rel(got, _float64_attention(q, k, v, True, None)) > 5 * FLASH_TOL


def _tf32_rna_float64(x: float) -> float:
    """x rounded to 11 significant bits, to nearest, ties away from zero,
    in float64 arithmetic (exact for float32 x)."""
    if x == 0 or not math.isfinite(x):
        return x
    m, e = math.frexp(abs(x))             # abs(x) = m 2^e, 0.5 <= m < 1
    r = math.floor(m * 2 ** 11 + 0.5)     # ties away on the magnitude
    return math.copysign(r * 2.0 ** (e - 11), x)


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0), (1 + 2 ** -11, 1 + 2 ** -10), (-(1 + 2 ** -11), -(1 + 2 ** -10)),
    (1 + 2 ** -11 - 2 ** -23, 1.0), (1 + 3 * 2 ** -11, 1 + 2 ** -9),
    (2 - 2 ** -23, 2.0), (float("inf"), float("inf")),
    (float("-inf"), float("-inf"))])
def test_tf32_rna_rounds_to_nearest_ties_away(x, want):
    got = F.tf32_rna(torch.tensor([x], dtype=torch.float32))
    assert float(got) == want
    assert F.tf32_rna(torch.tensor([float("nan")])).isnan().all()


finite_normal = st.floats(min_value=2.0 ** -100, max_value=2.0 ** 126,
                          allow_nan=False, allow_infinity=False, width=32)


@settings(max_examples=300, deadline=None)
@given(st.lists(finite_normal, min_size=1, max_size=64),
       st.lists(st.booleans(), min_size=64, max_size=64))
def test_split_reproduces_x(mags, signs):
    """hi + lo is x within 2^-22 |x|; hi and lo are TF32 (13 low bits
    clear), hi is x rounded as cvt.rna.tf32.f32 rounds."""
    x = torch.tensor([-m if s else m for m, s in zip(mags, signs)],
                     dtype=torch.float32)
    hi, lo = F.split_tf32(x)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    xd = x.double()
    err = (hi.double() + lo.double() - xd).abs()
    assert bool((err <= 2.0 ** -22 * xd.abs()).all())
    assert hi.tolist() == [_tf32_rna_float64(float(a)) for a in x]


def test_bf16_values_split_with_zero_lo():
    """A bfloat16 value is exact in TF32, so the passes with its lo, which
    the kernel drops for bf16 inputs, add exact zeros."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=4096)
                         .astype(np.float32)).to(torch.bfloat16).float()
    hi, lo = F.split_tf32(x)
    assert torch.equal(hi, x) and not bool(lo.any())
