"""Jacobi over-relaxation (paper eq. 36) for H q = b on strongly complete
graphs.

q_i^{s+1} = (1-w) q_i^s + (w / h_ii) (b_i - sum_{j != i} h_ij q_j^s)

Counterpart of the simulated mode of `repro.core.consensus.jor`. Each
agent owns row_i{H} and b_i and updates its own entry q_i; every
iteration needs the full vector q (strongly complete topology / flooding,
Remark 8). Lemma 2: converges for symmetric PD H if omega < 2/M; Lemma 3:
optimal omega* = 2 / (lambda_max(R) + lambda_min(R)), R = diag(H)^-1 H.

Batched: H (..., M, M) holds one system per leading index (one per query
in the NPAE family), where the reference vmaps. The update is affine, so
it is folded once into q^{s+1} = c + G q^s with G = (1-w) I -
diag(w/h_ii) R_off and c = (w/h_ii) b: one batched matrix product per
iteration for every system and right-hand side at once, with the iterates
and their residuals kept on the device.
"""
from __future__ import annotations

import torch

_CHUNK = 64          # iterations between two residual reductions


def _iterate(step, x0: torch.Tensor, iters: int):
    """x^{s+1} = step(x^s, out) for s < iters, x0 (B, ...).

    Returns (x^iters, residuals (iters, B)) with residual_s =
    max |x^{s+1} - x^s| over all but the leading axis, reduced once every
    _CHUNK iterations from a buffer of iterates (no host wait)."""
    B = x0.shape[0]
    res = x0.new_empty((iters, B))
    buf = x0.new_empty((min(_CHUNK, iters) + 1,) + tuple(x0.shape))
    buf[0] = x0
    s = 0
    while s < iters:
        n = min(_CHUNK, iters - s)
        for k in range(n):
            step(buf[k], buf[k + 1])
        res[s:s + n] = (buf[1:n + 1] - buf[:n]).abs() \
            .reshape(n, B, -1).amax(-1)
        buf[0] = buf[n]
        s += n
    return buf[0], res


def _masked(H, b, mask, vec: bool):
    """Decouple dead agents: rows and columns zeroed, unit diagonal, zero
    b, so the live block solves exactly the masked system."""
    mk = mask.to(H.dtype)
    H = H * (mk[..., :, None] * mk[..., None, :]) + torch.diag_embed(1.0 - mk)
    return H, b * (mk if vec else mk[..., None])


def jor(H, b, omega, iters: int, q0=None, mask=None):
    """Simulated-network JOR. H (..., M, M), b (..., M) or (..., M, K).

    `omega` is a number or a tensor of H's batch shape (one relaxation
    per system). `mask` (..., M) 0/1 decouples dead agents from the
    system (rows and columns zeroed, unit diagonal, zero b), so dead
    entries settle at 0. Returns (q of b's shape, residuals (..., iters)),
    residual_s = max |q^{s+1} - q^s| of each system."""
    vec = b.dim() == H.dim() - 1
    if mask is not None:
        H, b = _masked(H, b, mask, vec)
    M = H.shape[-1]
    batch = H.shape[:-2]
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    bm = b[..., None] if vec else b
    q = bm / d[..., None] if q0 is None else \
        (q0[..., None] if vec else q0).to(bm.dtype)
    om = torch.as_tensor(omega, dtype=H.dtype, device=H.device)
    om = om.expand(batch) if om.dim() == 0 else om
    w = (om[..., None] / d)[..., None]                     # (..., M, 1)
    eye = torch.eye(M, dtype=H.dtype, device=H.device)
    G = (1 - om)[..., None, None] * eye - w * (H - torch.diag_embed(d))
    c = w * bm
    K = bm.shape[-1]
    G3, c3 = G.reshape(-1, M, M), c.reshape(-1, M, K)
    q, res = _iterate(lambda x, out: torch.baddbmm(c3, G3, x, out=out),
                      q.expand_as(bm).reshape(-1, M, K), iters)
    q = q.reshape(bm.shape)
    return (q[..., 0] if vec else q), res.T.reshape(*batch, iters)


def jor_sharded(h_rows, bs, omega, iters: int):
    """Sharded JOR: mesh member i holds row_i{H} (M,) and b_i (a scalar
    tensor) and updates q_i; every iteration floods the q_j to every
    member (`flooding.flood_sharded`), the strongly complete exchange the
    paper flags as JOR's cost (Remark 8). Returns the members' q_i."""
    from .flooding import flood_sharded
    h_ii = [h[i] for i, h in enumerate(h_rows)]
    q = [b / d for b, d in zip(bs, h_ii)]
    for _ in range(iters):
        q_all = flood_sharded(q)
        q = [(1 - omega) * qi + (omega / d) * (b - (h @ qa - d * qa[i]))
             for i, (qi, qa, h, d, b) in enumerate(zip(q, q_all, h_rows,
                                                        h_ii, bs))]
    return q
