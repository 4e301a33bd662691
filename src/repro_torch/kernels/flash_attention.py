"""Blocked flash attention (online softmax) with GQA, causal and
sliding-window masking.

    o[b, h, i] = softmax_j(scale q[b, h, i] . k[b, h // g, j]) v[b, h // g, j]

over the keys the mask admits, for q (B, H, Sq, D) and k, v (B, KH, Sk, D)
with g = H / KH. Queries are right-aligned to the key timeline: query i
sits at position i + Sk - Sq (a decode step is Sq = 1 over the whole
cache). `causal` admits keys at or before the query, `window` w the keys
at positions > q_pos - w; with neither, every query admits every key, at
any Sq and Sk (the whisper decoder's cross-attention runs its prompt of
Sq tokens against Sk = 1,500 encoder frames, Sq > Sk at a long prompt).
It replaces the Pallas kernel
`repro/kernels/flash_attention.py:flash_attention_pallas`.

Both versions compute in float32 and return q's dtype, as the reference's
Pallas and chunked jnp paths do. Under a causal mask or a window, Sq > Sk
leaves the first rows with no admitted key (q_pos < 0), where the
reference returns the mean of v, as it does for a window of 0; the
reference never serves such a shape, and here both versions refuse it.

`flash_attention` dispatches on where its tensors lie. On the CPU it runs
`flash_attention_plain`, the plain PyTorch version. On a CUDA device it
launches the hand-written kernel `csrc/flash_attention.cu` (float32 or
bfloat16 inputs, head dimension 32, 64 or 128) or raises: there is no
fallback to the plain version on the card. `launches` counts kernel
launches, so a run can show that its path went through the kernel.

Training goes through `FlashAttentionFunction`, the counterpart of the
reference's `jax.custom_vjp` in `repro/kernels/flash_jnp.py` (the
reference has no backward Pallas kernel). Its forward is the kernel on a
CUDA tensor, which then also writes each row's log-sum-exp, and
`flash_attention_plain_lse` on the CPU; it saves (q, k, v, lse), and its
backward is `flash_attention_bwd`, a port of `flash_jnp._flash_bwd` in
plain PyTorch that recomputes the scores chunk by chunk, on both
devices. The kernel's launch path refuses an input that requires grad
while grad mode is on: the kernel writes its output through ctypes, out
of autograd's sight, so a gradient can reach it only through the
Function.

The kernel runs both products on the tensor cores in split TF32: a float32
x is hi + lo with hi = tf32_rna(x), lo = tf32_rna(x - hi), and a product
is lo hi' + hi lo' + hi hi' (three TF32 passes, float32 accuracy).
`tf32_rna`, `split_tf32` and `flash_attention_split_tf32` repeat that
arithmetic in plain PyTorch for the tests; nothing else calls them.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from . import _build

#: kernel launches since import or the last `reset_launches()`
launches = 0
#: devices whose tensors take the plain version: the CPU, and meta (a
#: shape-only path that computes nothing, for launch/dryrun.py)
PLAIN_DEVICES = ("cpu", "meta")

#: head dimensions the CUDA kernel is built for
KERNEL_DIMS = (32, 64, 128)


def reset_launches() -> None:
    global launches
    launches = 0


def check_shapes(q, k, v, window, causal: bool = True) -> None:
    """Raise ValueError unless q (B, H, Sq, D), k and v (B, KH, Sk, D) with
    H % KH == 0, window None or >= 1, Sk >= 1, and Sq <= Sk where the mask
    is causal or windowed (without either every row admits every key)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: want q (B, H, Sq, D), k and v "
                         f"(B, KH, Sk, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"flash_attention: H = {q.shape[1]} query heads "
                         f"are not a multiple of KH = {k.shape[1]}")
    if k.shape[2] == 0 or (q.shape[2] > k.shape[2]
                           and (causal or window is not None)):
        raise ValueError(f"flash_attention: Sq = {q.shape[2]}, Sk = "
                         f"{k.shape[2]}: with no key, or Sq > Sk under a "
                         f"causal or windowed mask, right-aligned queries "
                         f"would have no admitted key")
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


def _plain_scores(q, k, causal, window, scale):
    """The masked float32 scores (B, KH, g, Sq, Sk) of the plain version,
    -inf where the mask admits no key."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    g = H // KH
    scale = D ** -0.5 if scale is None else float(scale)
    qg = q.to(torch.float32).reshape(B, KH, g * Sq, D)
    s = (qg @ k.to(torch.float32).transpose(-1, -2) * scale) \
        .view(B, KH, g, Sq, Sk)
    s.masked_fill_(~mask(Sq, Sk, causal, window, q.device), float("-inf"))
    return s


def _plain_out(s, q, v):
    """softmax(s) v in float32, cast to q's dtype (B, H, Sq, D)."""
    B, KH, g, Sq, Sk = s.shape
    w = torch.softmax(s, dim=-1).view(B, KH, g * Sq, Sk)
    return (w @ v.to(torch.float32)).view(q.shape).to(q.dtype)


def flash_attention_plain(q, k, v, causal: bool = True, window=None,
                          scale=None):
    """Plain PyTorch version of the kernel: float32 scores, masked softmax,
    product with v, cast to q's dtype. GQA groups the g query heads of a
    kv head instead of repeating k and v; it materializes the
    (B, H, Sq, Sk) scores."""
    check_shapes(q, k, v, window, causal)
    return _plain_out(_plain_scores(q, k, causal, window, scale), q, v)


def flash_attention_plain_lse(q, k, v, causal: bool = True, window=None,
                              scale=None):
    """`flash_attention_plain` and each row's log-sum-exp of its admitted
    scaled scores: (out (B, H, Sq, D) in q's dtype, lse (B, H, Sq)
    float32), the plain version of the kernel's lse output and the
    counterpart of `flash_jnp._flash_fwd_impl`'s (out, lse)."""
    check_shapes(q, k, v, window, causal)
    s = _plain_scores(q, k, causal, window, scale)
    lse = torch.logsumexp(s, dim=-1).reshape(q.shape[:3])
    return _plain_out(s, q, v), lse


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
    check_shapes(q, k, v, window, causal)
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
        ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32,
        i32, ctypes.c_float, ptr]
    lib.flash_attention_launch.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, window, causal: bool = True):
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
    check_shapes(q, k, v, window, causal)
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


def _launch(q, k, v, causal, window, scale, with_lse: bool = False):
    """The kernel's output, and with `with_lse` also its (B, H, Sq) float32
    log-sum-exp. Raises on inputs that require grad while grad mode is on:
    the output would carry no gradient path (FlashAttentionFunction is the
    way to differentiate through the kernel)."""
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention kernel: an input requires grad and grad mode "
            "is on, but the kernel's output would have no gradient path; "
            "differentiate through FlashAttentionFunction "
            "(kernels.ops.flash_attention routes there)")
    _check(q, k, v, window, causal)
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    scale = D ** -0.5 if scale is None else float(scale)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, H, KH, Sq, Sk, D,
            int(q.dtype == torch.bfloat16), int(bool(causal)),
            0 if window is None else int(window), scale, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{lib.flash_attention_error_string(rc).decode()}")
    launches += 1
    return (out, lse) if with_lse else out


def flash_attention(q, k, v, causal: bool = True, window=None, scale=None):
    """q (B, H, Sq, D), k and v (B, KH, Sk, D) -> (B, H, Sq, D) in q's
    dtype; `scale` defaults to 1 / sqrt(D).

    CPU tensors run the plain version, and so do meta tensors (the dry
    run's shape-only path, which computes nothing); tensors on any other
    device go to the CUDA kernel, which takes contiguous float32 or
    bfloat16 inputs on one CUDA device and raises on anything else."""
    if q.device.type in PLAIN_DEVICES:
        return flash_attention_plain(q, k, v, causal, window, scale)
    return _launch(q, k, v, causal, window, scale)


def flash_attention_lse(q, k, v, causal: bool = True, window=None,
                        scale=None):
    """(out, lse): `flash_attention` and each row's log-sum-exp (B, H, Sq)
    float32 in natural log. The plain version on the CPU (and on meta),
    the kernel (one launch, its lse output on) on a CUDA device."""
    if q.device.type in PLAIN_DEVICES:
        return flash_attention_plain_lse(q, k, v, causal, window, scale)
    return _launch(q, k, v, causal, window, scale, with_lse=True)


#: keys a chunk of the training backward: the reference's op hands its
#: chunked path the largest divisor of Sk up to 1,024; this backward takes
#: a ragged last chunk, so it keeps 1,024 at every Sk
BWD_CHUNK = 1024


@contextlib.contextmanager
def _full_float32():
    """float32 matrix products in full float32 (TF32 off) on the card."""
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep


def flash_attention_bwd(q, k, v, lse, dout, causal: bool = True,
                        window=None, scale=None, chunk: int = 1024):
    """(dq, dk, dv) of the attention at (q, k, v) for the output gradient
    `dout`, from the forward's row log-sum-exp `lse` (B, H, Sq) float32:
    a port of `repro/kernels/flash_jnp.py:_flash_bwd` in plain PyTorch,
    on any device.

    For each chunk of `chunk` keys the scores s = scale q . k are
    recomputed, p = exp(s - lse), dp = dout v, ds = p (dp - delta) scale,
    dq += ds k, dk = ds^T q and dv = p^T dout, all in float32 with TF32
    off. One change from the reference: delta = sum_j p_j dp_j is summed
    over the recomputed p in a first pass over the chunks (as autograd's
    softmax backward forms it), where the reference takes sum_d dout *
    out. The two are equal when out = p v; the reference's forward and
    backward share their arithmetic, but the kernel's forward rounds
    differently (split TF32, ex2.approx) from this recompute, and at
    internlm2-1.8b's full width that mismatch, amplified by the keys'
    common component in sum_j ds_j k_j, took the wq and wk gradients
    5.2e-4 (of their max) from float64 against 7.0e-5 with the recomputed
    delta (PERF.md §6). A second change: the first pass also sums each
    row's recomputed p, and the second pass divides p and delta by that
    sum (lse += log sum p), so a row's weights sum to 1 whatever the
    forward's lse rounding. The kernel's lse is a few float32 ulps from
    the recompute's, a uniform scale e^-eps on the row's p that leaves
    eps p_j delta in every ds_j; summed into dq and dk against keys and
    queries with a common component it took whisper-small's attention
    wq / wk gradients 2.5-3.5e-2 (of their max) from the plain
    attention's (PERF.md §6). The g query heads of a kv head are grouped
    as rows of one product, so dk and dv come out summed over the GQA
    group. The last chunk may be ragged (the reference's chunked path
    reads a shifted slice there, ROADMAP C13; its op only passes divisors
    of Sk). Query rows that no key of a chunk admits are left out of that
    chunk's products: their p is exactly 0, so they add nothing.
    Returns dq in q's dtype, dk and dv in k's and v's."""
    check_shapes(q, k, v, window, causal)
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    g = H // KH
    sc = D ** -0.5 if scale is None else float(scale)
    chunk = max(1, min(int(chunk), Sk))
    off = Sk - Sq                      # right alignment: q_pos = i + off
    f32 = torch.float32
    q5 = q.to(f32).reshape(B, KH, g, Sq, D)
    do5 = dout.to(f32).reshape(B, KH, g, Sq, D)
    lse5 = lse.to(f32).reshape(B, KH, g, Sq)
    kf, vf = k.to(f32), v.to(f32)
    ok_all = mask(Sq, Sk, causal, window, q.device)

    def chunks():
        """(key range, row range, the rows' q and dout, the keys' k and v,
        the dp and p of the block) for every chunk that some row admits."""
        for c0 in range(0, Sk, chunk):
            c1 = min(c0 + chunk, Sk)
            # the query rows [r0, r1) that admit a key of [c0, c1)
            r0 = max(0, c0 - off) if causal else 0
            r1 = Sq if window is None else \
                max(0, min(Sq, c1 - 1 + int(window) - off))
            if r0 >= r1:
                continue
            R, C = r1 - r0, c1 - c0
            qs = q5[:, :, :, r0:r1].reshape(B, KH, g * R, D)
            dos = do5[:, :, :, r0:r1].reshape(B, KH, g * R, D)
            kc, vc = kf[:, :, c0:c1], vf[:, :, c0:c1]
            s = (qs @ kc.transpose(-1, -2)).mul_(sc).view(B, KH, g, R, C)
            s.masked_fill_(~ok_all[r0:r1, c0:c1], float("-inf"))
            p = s.sub_(lse5[:, :, :, r0:r1, None]).exp_() \
                .view(B, KH, g * R, C)
            yield (c0, c1, r0, r1, qs, dos, kc, vc,
                   dos @ vc.transpose(-1, -2), p)

    with _full_float32():
        delta5 = torch.zeros_like(lse5)
        lsum5 = torch.zeros_like(lse5)
        for _, _, r0, r1, _, _, _, _, dp, p in chunks():
            R = r1 - r0
            lsum5[:, :, :, r0:r1] += p.sum(-1).view(B, KH, g, R)
            delta5[:, :, :, r0:r1] += dp.mul_(p).sum(-1).view(B, KH, g, R)
        # normalize the recomputed p by its row sum (lse += log sum p);
        # the clamp keeps a row that no key admits at p = 0
        lsum5.clamp_(min=torch.finfo(f32).tiny)
        lse5 = lse5 + lsum5.log()
        delta5 /= lsum5
        del lsum5
        dq5 = torch.zeros_like(q5)
        dk = torch.zeros((B, KH, Sk, D), dtype=f32, device=q.device)
        dv = torch.zeros_like(dk)
        for c0, c1, r0, r1, qs, dos, kc, vc, dp, p in chunks():
            R, C = r1 - r0, c1 - c0
            ds = dp.view(B, KH, g, R, C).sub_(delta5[:, :, :, r0:r1, None]) \
                .view(B, KH, g * R, C).mul_(p).mul_(sc)
            dq5[:, :, :, r0:r1] += (ds @ kc).view(B, KH, g, R, D)
            dk[:, :, c0:c1] = ds.transpose(-1, -2) @ qs
            dv[:, :, c0:c1] = p.transpose(-1, -2) @ dos
            del ds, dp, p
    return (dq5.view(B, H, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashAttentionFunction(torch.autograd.Function):
    """Attention that autograd differentiates: the counterpart of the
    reference's `flash_attention_jnp` custom VJP.

    apply(q, k, v, causal, window, scale, chunk) -> out. The forward is
    `flash_attention_lse` (the kernel on a CUDA tensor, counted in
    `launches`; the plain version on the CPU) and saves (q, k, v, lse)
    (the reference also saves out, which `flash_attention_bwd` does not
    read); the backward is `flash_attention_bwd` with `chunk` keys a
    chunk. Under activation checkpointing the forward runs again in the
    backward and saves the replay's own lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, chunk):
        out, lse = flash_attention_lse(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v, lse)
        ctx.args = (causal, window, scale, chunk)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None
