"""Rank-1 Cholesky update / downdate over a fleet of factors.

For L (M, n, n) lower triangular and x (M, n):

    out[m] = chol(L_m L_m^T + sign x_m x_m^T)     (sign = +1, or -1 downdate)

in O(n^2) per agent by the LINPACK column sweep. `shift=s` updates the
trailing block L[:, s:, s:] with x[:, s:] and writes it s slots up-left —
the evict-the-oldest move of a sliding window (core.online). Rows n-s ..
n-1 of the result keep L's (stale) rows, and the upper triangle is zero.
`active` (M,) bool selects the agents that update; the others come back
as exact copies of L. A column whose x entry is zero is skipped, so a zero
x leaves a factor bitwise unchanged.

It replaces the Pallas kernel `repro/kernels/cholupdate.py:
cholupdate_pallas`, which the reference vmaps over agents; here one call
covers the whole fleet.

`cholupdate` dispatches on where its tensors lie. On the CPU it runs
`cholupdate_plain`, the plain PyTorch version, in the input dtype. On a
CUDA device it launches the hand-written kernel `csrc/cholupdate.cu`
(float32, 1 + ceil((n - s) / 32) device launches per call) or raises:
there is no fallback to the plain version on the card. `launches` counts
calls that launched the kernel, so a run can show that its path went
through it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

#: kernel calls since import or the last `reset_launches()`
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def cholupdate_plain(L, x, downdate: bool = False, shift: int = 0,
                     active=None):
    """Plain PyTorch version of the kernel, in the input dtype.

    L (M, n, n), x (M, n), active (M,) bool or None. The column sweep of
    the reference's `ref.cholupdate_ref`, batched over agents: the sqrt
    argument is clamped to the dtype's tiny, a column with x_k = 0 keeps
    its values, and the upper triangle comes back exactly zero."""
    M, n = x.shape
    sign = -1.0 if downdate else 1.0
    tiny = torch.finfo(L.dtype).tiny
    m = n - shift
    sub = L[:, shift:, shift:].clone()
    xc = x[:, shift:].clone()
    for k in range(m):
        col, xt = sub[:, k:, k], xc[:, k:]
        Lkk, xk = col[:, 0], xt[:, 0]
        on = xk != 0
        r = torch.sqrt(torch.clamp(Lkk * Lkk + sign * xk * xk, min=tiny))
        c = torch.where(on, r / Lkk, torch.ones_like(Lkk))
        s = torch.where(on, xk / Lkk, torch.zeros_like(xk))
        u = col + (sign * s)[:, None] * xt
        u[:, 0] = torch.where(on, r * c, Lkk)
        xnew = c[:, None] * xt - (s / c)[:, None] * u
        sub[:, k:, k] = torch.where(on[:, None], u / c[:, None], col)
        xc[:, k:] = torch.where(on[:, None], xnew, xt)
    out = L.clone()
    out[:, :m, :m] = sub
    out = torch.tril(out)
    if active is not None:
        out = torch.where(active[:, None, None], out, L)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("cholupdate")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cholupdate_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                      i32, ptr]
    lib.cholupdate_launch.restype = i32
    lib.cholupdate_error_string.argtypes = [i32]
    lib.cholupdate_error_string.restype = ctypes.c_char_p
    return lib


def _check(L, x, shift, active):
    """Raise unless the inputs are what the kernel takes: L float32,
    contiguous (M, n, n); x float32 (M, n); active None or bool (M,);
    0 <= shift <= n; all on the CUDA device of L."""
    for name, t in (("L", L), ("x", x)):
        if t.dtype != torch.float32:
            raise TypeError(f"cholupdate kernel: {name} must be float32, "
                            f"got {t.dtype}")
    if not L.is_contiguous():
        raise ValueError("cholupdate kernel: L must be contiguous")
    if L.dim() != 3 or L.shape[1] != L.shape[2] or x.shape != L.shape[:2] \
            or (active is not None and (active.dtype != torch.bool
                                        or active.shape != L.shape[:1])) \
            or not 0 <= shift <= L.shape[-1]:
        raise ValueError(f"cholupdate kernel: want L (M, n, n), x (M, n), "
                         f"active (M,) bool, 0 <= shift <= n; got "
                         f"{tuple(L.shape)}, {tuple(x.shape)}, "
                         f"{None if active is None else tuple(active.shape)},"
                         f" shift={shift}")
    for name, t in (("L", L), ("x", x), ("active", active)):
        if t is not None and (t.device.type != "cuda"
                              or t.device != L.device):
            raise ValueError(f"cholupdate kernel: {name} must lie on the "
                             f"CUDA device of L, got {t.device}")


def _launch(L, x, downdate, shift, active):
    global launches
    _check(L, x, shift, active)
    M, n, _ = L.shape
    out = torch.empty_like(L)
    if M == 0 or n == 0:
        return out
    lib = _library()
    xs = torch.empty((M, n), dtype=torch.float32, device=L.device)
    xs.copy_(x)                           # the kernel rotates its scratch
    act = None if active is None else active.to(torch.uint8).contiguous()
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream(L.device).cuda_stream
        rc = lib.cholupdate_launch(L.data_ptr(), out.data_ptr(),
                                   xs.data_ptr(),
                                   None if act is None else act.data_ptr(),
                                   M, n, int(shift), int(bool(downdate)),
                                   stream)
    if rc != 0:
        raise RuntimeError(f"cholupdate kernel launch failed: "
                           f"{lib.cholupdate_error_string(rc).decode()}")
    launches += 1
    return out


def cholupdate(L, x, downdate: bool = False, shift: int = 0, active=None):
    """L (M, n, n), x (M, n) -> the updated factors (M, n, n).

    CPU tensors run the plain version in their dtype; tensors on any other
    device go to the CUDA kernel, which takes float32 on one CUDA device
    and raises on anything else."""
    if L.device.type == "cpu":
        return cholupdate_plain(L, x, downdate, shift, active)
    return _launch(L, x, downdate, shift, active)
