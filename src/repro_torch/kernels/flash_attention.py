"""Blocked flash attention (online softmax) with GQA, causal and
sliding-window masking.

    o[b, h, i] = softmax_j(scale q[b, h, i] . k[b, h // g, j]) v[b, h // g, j]

over the keys the mask admits, for q (B, H, Sq, D) and k, v (B, KH, Sk, D)
with g = H / KH. Queries are right-aligned to the key timeline: query i
sits at position i + Sk - Sq, so Sq <= Sk (a decode step is Sq = 1 over the
whole cache). `causal` admits keys at or before the query, `window` w the
keys at positions > q_pos - w. It replaces the Pallas kernel
`repro/kernels/flash_attention.py:flash_attention_pallas`.

Both versions compute in float32 and return q's dtype, as the reference's
Pallas and chunked jnp paths do. The reference returns the mean of v for
a row with no admitted key (Sq > Sk, or a window of 0); the reference
never serves such a shape, and here both versions refuse it.

`flash_attention` dispatches on where its tensors lie. On the CPU it runs
`flash_attention_plain`, the plain PyTorch version. On a CUDA device it
launches the hand-written kernel `csrc/flash_attention.cu` (float32 or
bfloat16 inputs, head dimension 32, 64 or 128) or raises: there is no
fallback to the plain version on the card. `launches` counts kernel
launches, so a run can show that its path went through the kernel.

The kernel runs both products on the tensor cores in split TF32: a float32
x is hi + lo with hi = tf32_rna(x), lo = tf32_rna(x - hi), and a product
is lo hi' + hi lo' + hi hi' (three TF32 passes, float32 accuracy).
`tf32_rna`, `split_tf32` and `flash_attention_split_tf32` repeat that
arithmetic in plain PyTorch for the tests; nothing else calls them.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

#: kernel launches since import or the last `reset_launches()`
launches = 0

#: head dimensions the CUDA kernel is built for
KERNEL_DIMS = (32, 64, 128)


def reset_launches() -> None:
    global launches
    launches = 0


def check_shapes(q, k, v, window) -> None:
    """Raise ValueError unless q (B, H, Sq, D), k and v (B, KH, Sk, D) with
    H % KH == 0, Sq <= Sk, and window None or >= 1."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: want q (B, H, Sq, D), k and v "
                         f"(B, KH, Sk, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"flash_attention: H = {q.shape[1]} query heads "
                         f"are not a multiple of KH = {k.shape[1]}")
    if q.shape[2] > k.shape[2]:
        raise ValueError(f"flash_attention: Sq = {q.shape[2]} > Sk = "
                         f"{k.shape[2]}; right-aligned queries would have "
                         f"no admitted key")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be None or >= 1, "
                         f"got {window}")


def mask(Sq: int, Sk: int, causal: bool, window, device=None):
    """(Sq, Sk) bool: the keys each right-aligned query admits."""
    q_pos = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    k_pos = torch.arange(Sk, device=device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    return ok


def flash_attention_plain(q, k, v, causal: bool = True, window=None,
                          scale=None):
    """Plain PyTorch version of the kernel: float32 scores, masked softmax,
    product with v, cast to q's dtype. GQA groups the g query heads of a
    kv head instead of repeating k and v; it materializes the
    (B, H, Sq, Sk) scores."""
    check_shapes(q, k, v, window)
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    g = H // KH
    scale = D ** -0.5 if scale is None else float(scale)
    qg = q.to(torch.float32).reshape(B, KH, g * Sq, D)
    s = (qg @ k.to(torch.float32).transpose(-1, -2) * scale) \
        .view(B, KH, g, Sq, Sk)
    s.masked_fill_(~mask(Sq, Sk, causal, window, q.device), float("-inf"))
    w = torch.softmax(s, dim=-1).view(B, KH, g * Sq, Sk)
    return (w @ v.to(torch.float32)).view(B, H, Sq, D).to(q.dtype)


def tf32_rna(x):
    """float32 x rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as `cvt.rna.tf32.f32` rounds: add half of the 13 dropped
    bits to the magnitude and clear them. inf and NaN pass unchanged."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_rna: want float32, got {x.dtype}")
    bits = (x.view(torch.int32) + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), bits.view(torch.float32), x)


def split_tf32(x):
    """(hi, lo) with hi = tf32_rna(x) and lo = tf32_rna(x - hi): the
    kernel's split of a float32 operand; x - hi is exact, and hi + lo is x
    within 2^-22 |x| for normal x."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def flash_attention_split_tf32(q, k, v, causal: bool = True, window=None,
                               scale=None, passes: int = 3):
    """The kernel's arithmetic in plain PyTorch on float32: the blocked
    online softmax over 64-key tiles, each tile's keys in the kernel's
    order (score column c of an 8-key group is key (c >> 1) + 4 (c & 1)),
    the scores scaled by scale log2(e) in float32, exp2, and both products
    from TF32 operands: `passes` 3 sums lo hi' + hi lo' + hi hi' (the
    kernel), 1 takes hi hi' alone (plain TF32). Products of TF32 values are
    exact in float32; the sums round in float32 in another order than the
    tensor cores'. Returns q's dtype."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    check_shapes(q, k, v, window)
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    g = H // KH
    scale = D ** -0.5 if scale is None else float(scale)
    qmul = torch.tensor(scale, dtype=torch.float32) * \
        torch.tensor(math.log2(math.e), dtype=torch.float32)

    def prod(a, b):
        ah, al = split_tf32(a)
        bh, bl = split_tf32(b)
        if passes == 1:
            return ah @ bh
        return al @ bh + ah @ bl + ah @ bh

    qf = q.to(torch.float32).reshape(B, KH, g * Sq, D)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    ok = mask(Sq, Sk, causal, window, q.device)
    order = torch.tensor([8 * j + (c >> 1) + 4 * (c & 1)
                          for j in range(8) for c in range(8)],
                         device=q.device)
    m = torch.full((B, KH, g * Sq), float("-inf"), device=q.device)
    l = torch.zeros((B, KH, g * Sq), device=q.device)
    o = torch.zeros((B, KH, g * Sq, D), device=q.device)
    for k0 in range(0, Sk, 64):
        keys = k0 + order[k0 + order < Sk]
        s = prod(qf, kf[:, :, keys].transpose(-1, -2)) * qmul
        s = s.view(B, KH, g, Sq, -1).masked_fill(
            ~ok[:, keys], float("-inf")).view(B, KH, g * Sq, -1)
        mnew = torch.maximum(m, s.amax(-1))
        mref = torch.where(mnew == float("-inf"), 0.0, mnew)
        corr = torch.exp2(m - mref)
        p = torch.exp2(s - mref[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + prod(p, vf[:, :, keys])
        m = mnew
    return (o * (1 / l)[..., None]).view(B, H, Sq, D).to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("flash_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, i32,
        ctypes.c_float, ptr]
    lib.flash_attention_launch.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, window):
    """Raise unless the inputs are what the kernel takes: one dtype,
    float32 or bfloat16, contiguous and 16-byte aligned, D in KERNEL_DIMS,
    the shapes of `check_shapes`, all on the CUDA device of q."""
    tensors = {"q": q, "k": k, "v": v}
    for name, t in tensors.items():
        if t.dtype not in (torch.float32, torch.bfloat16) \
                or t.dtype != q.dtype:
            raise TypeError(f"flash_attention kernel: q, k and v must all be "
                            f"float32 or all bfloat16, got {name} "
                            f"{t.dtype} with q {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} must be "
                             f"contiguous")
    check_shapes(q, k, v, window)
    if q.shape[3] not in KERNEL_DIMS:
        raise ValueError(f"flash_attention kernel: head dimension "
                         f"D={q.shape[3]} is not one of {KERNEL_DIMS}")
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention kernel: {name} must lie on "
                             f"the CUDA device of q, got {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel: {name} must be "
                             f"16-byte aligned")


def _launch(q, k, v, causal, window, scale):
    global launches
    _check(q, k, v, window)
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = D ** -0.5 if scale is None else float(scale)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            KH, Sq, Sk, D, int(q.dtype == torch.bfloat16), int(bool(causal)),
            0 if window is None else int(window), scale, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{lib.flash_attention_error_string(rc).decode()}")
    launches += 1
    return out


def flash_attention(q, k, v, causal: bool = True, window=None, scale=None):
    """q (B, H, Sq, D), k and v (B, KH, Sk, D) -> (B, H, Sq, D) in q's
    dtype; `scale` defaults to 1 / sqrt(D).

    CPU tensors run the plain version; tensors on any other device go to
    the CUDA kernel, which takes contiguous float32 or bfloat16 inputs on
    one CUDA device and raises on anything else."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, scale)
    return _launch(q, k, v, causal, window, scale)
