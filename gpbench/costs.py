"""The yardstick's arithmetic: published peaks of the card, each kernel's
least time from its shapes, and the algorithmic work of one unit of each
cell (a served query row, an ADMM iteration, an observe round).

Peaks (NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power
limit; a card set below it runs slower, so every reading is printed beside
the card's name and power limit):

  HBM_BYTES_PER_S   3.35 TB/s, the HBM3 bandwidth.
  FP32_FLOPS_PER_S  67 TFLOP/s, float32 outside the tensor cores: the
                    port's products stay out of single-pass TF32.
  SFU_EXP_PER_S     exp2 results per second on the special-function units:
                    16 a clock per SM against 128 float32 lanes that each
                    retire a fused multiply-add (2 flops) a clock (CUDA C++
                    Programming Guide, arithmetic instruction throughput,
                    compute capability 9.0), so FP32_FLOPS_PER_S * 16 / 256.
                    Derived from the published float32 peak, so no clock
                    is assumed.

The three kernel bounds start from `chip_smoke.py`'s `rbf_matvec_bound_ms`,
`nll_grad_bound_ms` and `cholupdate_bound_ms`, with the SFU rate taken from
the published peak above instead of an assumed SM clock, and each bound's
bytes counted from the function's own inputs and outputs rather than from
what the present implementation happens to move: `nll_grad` reads the
points X, not the cached distances d2u that follow from them, and
`cholupdate` writes the factor's lower triangle, not its full square. A
kernel that moves less than today's therefore never reads above 100 %.
Each returns (milliseconds, "bytes" | "operations").
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SFU_EXP_PER_S = FP32_FLOPS_PER_S * 16 / 256
F32 = 4                                  # bytes of a float32


def least_s(flops: float, bytes_: float) -> float:
    """Least seconds on the card for work of `flops` float32 operations
    and `bytes_` moved through HBM: the larger of the two over its peak."""
    return max(flops / FP32_FLOPS_PER_S, bytes_ / HBM_BYTES_PER_S)


def _bound(t_bytes: float, t_ops: float) -> tuple[float, str]:
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                        else "operations")


def rbf_matvec_bound_ms(Nt: int, M: int, Ni: int, D: int):
    """Least time for out (M, Nt) = sf2 * exp(-d2) @ v: each input (the
    queries, the M agents' points and weights, the D lengthscales and sf2)
    read once and the output written once over the memory rate, or per
    (query, point) pair one exp2 on the SFUs and 3D + 3 float32 flops (D
    subtracts, D fused multiply-adds, the log2(e) scale, the accumulating
    fused multiply-add) over their peak rates, whichever is larger."""
    pairs = Nt * M * Ni
    bytes_ = F32 * (Nt * D + M * Ni * D + M * Ni + D + 1 + M * Nt)
    t_ops = max(pairs * (3 * D + 3) / FP32_FLOPS_PER_S,
                pairs / SFU_EXP_PER_S)
    return _bound(bytes_ / HBM_BYTES_PER_S, t_ops)


def nll_grad_bound_ms(M: int, N: int, D: int):
    """Least time for the (M, D+2) sums of W = inner * sf2 exp(-d2s): the
    points X (M, N, D) and inner (M, N, N) read once, params in and sums
    out, over the memory rate (the distances follow from X, so a kernel
    that caches them moves more than the function needs); or per element
    one exp on the SFUs and 4D + 3 float32 flops over their peak rates,
    whichever is larger."""
    elems = M * N * N
    bytes_ = F32 * (M * N * N + M * N * D + M * (D + 1) + M * (D + 2))
    t_ops = max(elems * (4 * D + 3) / FP32_FLOPS_PER_S,
                elems / SFU_EXP_PER_S)
    return _bound(bytes_ / HBM_BYTES_PER_S, t_ops)


def cholupdate_bound_ms(M: int, n: int, shift: int):
    """Least time for the rank-1 update of M factors, out of place: the
    lower triangle of each (n, n) factor read once, the lower triangle of
    each updated factor written once and x read, over the memory rate; or
    5 float32 operations per updated element of the (n - shift) block over
    their peak rate, whichever is larger."""
    m = n - shift
    elems = M * m * (m + 1) // 2
    tri = M * n * (n + 1) // 2
    t_bytes = F32 * (2 * tri + M * m) / HBM_BYTES_PER_S
    return _bound(t_bytes, 5 * elems / FP32_FLOPS_PER_S)


# -- algorithmic work of one unit, whatever implements it --------------------

def serve_row_work(M: int, Ni: int, D: int, chunk: int):
    """(flops, bytes) of answering ONE query row of an M-agent fleet of Ni
    points each: per agent the cross-kernel row (3D + 3 flops and an exp
    per point, counted as flops), the mean k . alpha (2 Ni), the variance
    solve against the agent's factor (Ni^2) and |v|^2 (2 Ni). Bytes: each
    agent's lower-triangular factor is read once per `chunk`-row tile, so a
    row carries 1/chunk of it, plus the agents' points and weights."""
    flops = M * (Ni * (3 * D + 4) + 2 * Ni + Ni * Ni + 2 * Ni)
    factor = M * Ni * (Ni + 1) // 2
    bytes_ = F32 * (factor + M * Ni * (D + 1)) / chunk + F32 * (D + 2)
    return flops, bytes_


def admm_iter_work(M: int, N: int, D: int):
    """(flops, bytes) of one DEC-apx-GP iteration (eq. 34) of an M-agent
    fleet of N points each: per agent the covariance from the cached
    geometry (D + 3 flops an element), the Cholesky (N^3 / 3), the inverse
    from the factor (L^-1: N^3 / 3; L^-T L^-1: N^3 / 3), alpha (2 N^2), the
    outer product (2 N^2) and the trace-identity contraction (4D + 3 an
    element). Bytes: the points X (N D) and the inner matrix (N^2) read
    once by the contraction, the covariance written and read once."""
    n2, n3 = N * N, N ** 3
    flops = M * (n2 * (D + 3) + n3 + 4 * n2 + n2 * (4 * D + 3))
    bytes_ = F32 * M * (3 * n2 + N * D)
    return flops, bytes_


def observe_round_work(M: int, W: int):
    """(flops, bytes) of one observe round (one new observation per agent
    into full windows of W points): the rank-1 downdate of the trailing
    block (read and write the lower triangle), the new row's forward solve
    (read the triangle) and alpha's two solves (read it twice): five
    passes over the M lower triangles. Flops: 5 an updated element, W^2
    for the new row's solve and 2 W^2 for alpha's."""
    tri = M * W * (W + 1) // 2
    flops = 5 * tri + M * 3 * W * W
    return flops, F32 * 5 * tri
