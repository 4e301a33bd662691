"""Public kernel ops with the reference's signatures (repro.kernels.ops).

The CUDA path computes in float32 like the reference's Pallas path
(repro/kernels/ops.py: rbf_gram, rbf_matvec and nll_grad_fused cast
their operands to float32); the CPU path keeps the input dtype like the
reference's jnp path. rbf_gram returns float32 on the card, as the
reference's Pallas path does; kmn_stats promotes each panel to X's dtype
before its products; rbf_matvec's callers cast the result back to their
query dtype (core.prediction.local.stream_means); nll_grad_fused returns
d2u's dtype; cholupdate returns L's dtype, as the reference's does.
flash_attention computes in float32 on both paths and returns q's dtype,
as both of the reference's paths do.
"""
from __future__ import annotations

import torch

from . import cholupdate as _cholupdate
from . import flash_attention as _flash
from . import nll_grad as _nll_grad
from . import rbf_gram as _rbf_gram
from . import rbf_matvec as _rbf_matvec


def _gram_operands(Z, X, lengthscales, sigma_f, noise):
    """Inputs pre-scaled by 1/lengthscale and params (sigma_f^2, noise^2),
    cast to float32 and made contiguous on the card."""
    a = Z / lengthscales
    b = X / lengthscales
    params = torch.stack([torch.as_tensor(sigma_f, dtype=a.dtype,
                                          device=a.device) ** 2,
                          torch.as_tensor(noise, dtype=a.dtype,
                                          device=a.device) ** 2])
    if a.device.type != "cpu":
        a, b, params = (t.to(torch.float32).contiguous()
                        for t in (a, b, params))
    return a, b, params


def rbf_gram_agents(Z, X, lengthscales, sigma_f, noise=0.0,
                    with_noise: bool = False):
    """Every agent's k(Z_a, X_a) in one kernel call -> (M, m, N).

    Z (M, m, D), X (M, N, D); `with_noise` adds noise^2 where the row index
    equals the column index (the square case)."""
    a, b, params = _gram_operands(Z, X, lengthscales, sigma_f, noise)
    return _rbf_gram.rbf_gram(a, b, params, with_noise)


def rbf_gram(x1, x2, lengthscales, sigma_f, noise=0.0,
             with_noise: bool = False):
    """Public RBF Gram op. x1 (N, D), x2 (M, D) -> (N, M).

    Signature of the reference's `ops.rbf_gram`; `with_noise=True` adds
    noise^2 on the global diagonal (square case)."""
    return rbf_gram_agents(x1[None], x2[None], lengthscales, sigma_f, noise,
                           with_noise)[0]


def kmn_stats_agents(Z, X, y, lengthscales, sigma_f, bn: int = 4096):
    """Blocked Titsias statistics of every agent, B = Kmn Knm (M, m, m)
    and b = Kmn y (M, m), for Kmn = k(Z_a, X_a) — the one O(N) pass of a
    sparse-expert fit (core.sparse.fit_sparse_experts).

    X (M, N, D) is streamed one (M, m, bn) panel at a time, one rbf_gram
    launch per panel for the whole fleet, so transient memory is O(M m bn)
    at any N. The tail panel's columns past N are exactly 0 and y is
    zero-padded there, so they contribute to neither statistic (the
    reference multiplies its padded panel by zero weights). Each panel is
    promoted to X's dtype before the two products, which accumulate in X's
    dtype."""
    M, N, _ = X.shape
    m = Z.shape[1]
    bn = min(bn, max(1, N))
    a, b, params = _gram_operands(Z, X, lengthscales, sigma_f, 0.0)
    yb = torch.nn.functional.pad(y.to(X.dtype), (0, (-N) % bn))
    B = torch.zeros((M, m, m), dtype=X.dtype, device=X.device)
    bvec = torch.zeros((M, m, 1), dtype=X.dtype, device=X.device)
    for j0 in range(0, N, bn):
        Kb = _rbf_gram.rbf_gram(a, b, params, col0=j0, width=bn).to(X.dtype)
        B.baddbmm_(Kb, Kb.mT)
        bvec.baddbmm_(Kb, yb[:, j0:j0 + bn, None])
    return B, bvec[..., 0]


def kmn_stats(Z, X, y, lengthscales, sigma_f, bn: int = 4096):
    """Blocked Titsias statistics of one agent -> (B (m, m), b (m,)).

    Signature of the reference's `ops.kmn_stats`: Z (m, D), X (N, D),
    y (N,)."""
    B, b = kmn_stats_agents(Z[None], X[None], y[None], lengthscales, sigma_f,
                            bn)
    return B[0], b[0]


def rbf_matvec_agents(Xs, Xp, alpha, lengthscales, sf2):
    """Every agent's k(Xs, X_m) @ alpha_m in one kernel call -> (M, Nt).

    Xs (Nt, D) queries, Xp (M, Ni, D) agent inputs, alpha (M, Ni) weights,
    lengthscales (D,) and sf2 = sigma_f^2 (one element). The kernel scales
    the inputs by 1/lengthscale itself, so on float32, contiguous inputs
    on the card this is the launch alone; other inputs are cast to float32
    first, as the reference's op casts its operands."""
    args = (Xs, Xp, alpha, lengthscales, sf2.reshape(1))
    if Xs.device.type != "cpu":
        args = tuple(t.to(torch.float32).contiguous() for t in args)
    return _rbf_matvec.rbf_matvec(*args)


def rbf_matvec(x1, x2, v, lengthscales, sigma_f):
    """Fused k(X1, X2) @ v with O(N + M) memory -> (N,).

    Signature of the reference's `ops.rbf_matvec`: x1 (N, D), x2 (M, D),
    v (M,)."""
    sigma_f = torch.as_tensor(sigma_f, dtype=x1.dtype, device=x1.device)
    return rbf_matvec_agents(x1, x2[None], v[None],
                             torch.as_tensor(lengthscales, dtype=x1.dtype,
                                             device=x1.device),
                             sigma_f**2)[0]


def nll_grad_fused_agents(log_theta, d2u, inner, K=None):
    """Every agent's dNLL/dlog_theta in one kernel call -> (M, D+2).

    log_theta (M, D+2), d2u (M, D, N, N) the once-per-fit unscaled diff^2
    stacks, inner (M, N, N) = C^-1 - alpha alpha^T of this iteration (paper
    eq. 4, trace identity). The kernel returns the sums [sum W d2u[d],
    sum W, tr(inner)]; the log-theta chain rule is applied here in d2u's
    dtype: sums[:D] / l^2, sums[D], sigma_eps^2 sums[D+1]. On the card the
    operands are cast to float32 and `K` is ignored, as the reference's
    Pallas path does; on the CPU the plain version reuses `K`."""
    D = d2u.shape[-3]
    theta = torch.exp(log_theta)
    ls, sigma_f, sigma_eps = theta[..., :D], theta[..., D], theta[..., D + 1]
    params = torch.cat([1.0 / ls**2, (sigma_f**2)[..., None]], -1)
    if d2u.device.type != "cpu":
        d2u_k, inner, params = (t.to(torch.float32).contiguous()
                                for t in (d2u, inner, params))
        sums = _nll_grad.nll_grad(d2u_k, inner, params)
    else:
        sums = _nll_grad.nll_grad(d2u, inner, params, K=K)
    sums = sums.to(d2u.dtype)
    return torch.cat([sums[..., :D] / ls**2, sums[..., D:D + 1],
                      sigma_eps[..., None]**2 * sums[..., D + 1:]], -1)


def nll_grad_fused(log_theta, d2u, inner, K=None):
    """Fused trace-identity NLL gradient of one agent -> (D+2,).

    Signature of the reference's `ops.nll_grad_fused`: log_theta (D+2,),
    d2u (D, N, N), inner (N, N), K (N, N) or None."""
    return nll_grad_fused_agents(log_theta[None], d2u[None], inner[None],
                                 None if K is None else K[None])[0]


def cholupdate_fleet(L, x, downdate: bool = False, shift: int = 0,
                     active=None):
    """Every agent's rank-1 update chol(L L^T +/- x x^T) in one kernel call
    -> (M, n, n) in L's dtype. On the card that call is one persistent
    wavefront launch for the whole fleet (and the fill of its scratch),
    bit for bit the plain version's float32 result.

    L (M, n, n) lower triangular, x (M, n), `active` (M,) bool or None
    (agents left out come back unchanged). `shift=k` updates the trailing
    block with x[:, k:] and returns it moved k slots up-left; rows n-k ..
    n-1 of the result are L's stale rows. On the card the operands are cast
    to float32 and the result back to L's dtype, as the reference's Pallas
    path does; on the CPU the plain version keeps L's dtype."""
    if L.device.type == "cpu":
        return _cholupdate.cholupdate(L, x, downdate, shift, active)
    out = _cholupdate.cholupdate(L.to(torch.float32).contiguous(),
                                 x.to(torch.float32), downdate, shift,
                                 active)
    return out.to(L.dtype)


def cholupdate(L, x, downdate: bool = False, shift: int = 0):
    """Rank-1 Cholesky update/downdate of one factor -> (n, n).

    Signature of the reference's `ops.cholupdate`: L (n, n) lower
    triangular, x (n,)."""
    return cholupdate_fleet(L[None], x[None], downdate, shift)[0]


def flash_attention(q, k, v, causal: bool = True, window=None, scale=None):
    """Public attention op. q (B, H, Sq, D), k/v (B, KH, Sk, D) ->
    (B, H, Sq, D) in q's dtype, queries right-aligned to the key timeline.

    Signature of the reference's `ops.flash_attention` less its execution
    options (`use_pallas`, `interpret`, block sizes): the tensor's device
    decides. A CPU tensor takes the plain version (and a meta tensor, the
    dry run's shape-only path); a CUDA tensor goes to
    the hand-written kernel, made contiguous here, which masks its own
    ragged edges (the reference's op picks divisor block sizes instead).

    With grad mode on and an input that requires grad, it goes through
    `FlashAttentionFunction` (the kernel, with its log-sum-exp output, or
    the plain version forward; the ported chunked backward over chunks of
    `BWD_CHUNK` keys), as the reference's op differentiates through
    `flash_attention_jnp`. Otherwise (serving) no log-sum-exp is
    written."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _flash.FlashAttentionFunction.apply(
            q.contiguous(), k.contiguous(), v.contiguous(), causal, window,
            scale, _flash.BWD_CHUNK)
    if q.device.type in _flash.PLAIN_DEVICES:
        return _flash.flash_attention_plain(q, k, v, causal, window, scale)
    return _flash.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal, window, scale)
