"""One-pass trace-identity NLL gradient sums over a fleet of agents.

For d2u (M, D, N, N) — the unscaled diff^2 stacks — inner (M, N, N) =
C^-1 - alpha alpha^T and params (M, D+1) = [1/l_1^2 .. 1/l_D^2, sigma_f^2],
with K = sigma_f^2 exp(-sum_d d2u[d] / l_d^2) and W = inner * K:

    out[m] = [sum W * d2u[0], ..., sum W * d2u[D-1], sum W, tr(inner)]

(M, D+2): every term of each agent's eq. 4 gradient in one read of d2u and
inner. It replaces the Pallas kernel `repro/kernels/nll_grad.py:
nll_grad_pallas`, which the reference vmaps over agents; here one launch
covers the whole fleet. kernels.ops.nll_grad_fused applies the chain rule.

`nll_grad` dispatches on where its tensors lie. On the CPU it runs
`nll_grad_plain`, the plain PyTorch version, in the input dtype. On a CUDA
device it launches the hand-written kernel `csrc/nll_grad.cu` (float32) or
raises: there is no fallback to the plain version on the card. `launches`
counts kernel launches, so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

#: kernel launches since import or the last `reset_launches()`
launches = 0

_BLOCKS_PER_SM = 16       # aim for this many row blocks per SM
_MAX_D = 32               # kMaxD in csrc/nll_grad.cu


def reset_launches() -> None:
    global launches
    launches = 0


def nll_grad_plain(d2u, inner, params, K=None):
    """Plain PyTorch version of the kernel, in the input dtype.

    Takes any leading batch dimensions. `K` (..., N, N) optionally reuses
    an already-built kernel matrix instead of rebuilding it from d2u."""
    D = d2u.shape[-3]
    if K is None:
        d2s = torch.einsum("...d,...dij->...ij", params[..., :D], d2u)
        K = params[..., D, None, None] * torch.exp(-d2s)
    W = inner * K
    return torch.cat([torch.einsum("...dij,...ij->...d", d2u, W),
                      W.sum((-2, -1))[..., None],
                      torch.diagonal(inner, dim1=-2, dim2=-1)
                      .sum(-1)[..., None]], -1)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("nll_grad")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.nll_grad_launch.argtypes = [ptr, ptr, ptr, ptr, ptr,
                                    i32, i32, i32, i32, i32, ptr]
    lib.nll_grad_launch.restype = i32
    lib.nll_grad_error_string.argtypes = [i32]
    lib.nll_grad_error_string.restype = ctypes.c_char_p
    return lib


def _check(d2u, inner, params):
    """Raise unless the inputs are what the kernel takes: float32,
    contiguous, d2u (M, D, N, N), inner (M, N, N), params (M, D+1) with
    D <= 32, all on the CUDA device of d2u."""
    tensors = {"d2u": d2u, "inner": inner, "params": params}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"nll_grad kernel: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"nll_grad kernel: {name} must be contiguous")
    if d2u.dim() != 4 or inner.dim() != 3 or params.dim() != 2 \
            or d2u.shape[2] != d2u.shape[3] \
            or inner.shape != (d2u.shape[0], *d2u.shape[2:]) \
            or params.shape != (d2u.shape[0], d2u.shape[1] + 1) \
            or not 1 <= d2u.shape[1] <= _MAX_D:
        raise ValueError(f"nll_grad kernel: want d2u (M, D, N, N) with "
                         f"D <= {_MAX_D}, inner (M, N, N), params (M, D+1); "
                         f"got {tuple(d2u.shape)}, {tuple(inner.shape)}, "
                         f"{tuple(params.shape)}")
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != d2u.device:
            raise ValueError(f"nll_grad kernel: {name} must lie on the "
                             f"CUDA device of d2u, got {t.device}")


def blocks_for(M: int, N: int, sm_count: int) -> int:
    """Row blocks per agent: about `_BLOCKS_PER_SM` blocks per SM over the
    fleet, so a 4-agent plane fills the card several times over; never
    more blocks than rows."""
    return max(1, min(N, -(-_BLOCKS_PER_SM * sm_count // M)))


def _launch(d2u, inner, params):
    global launches
    _check(d2u, inner, params)
    M, D, N, _ = d2u.shape
    if M == 0 or N == 0:
        return torch.zeros((M, D + 2), dtype=torch.float32,
                           device=d2u.device)
    out = torch.empty((M, D + 2), dtype=torch.float32, device=d2u.device)
    lib = _library()
    sms = torch.cuda.get_device_properties(d2u.device).multi_processor_count
    blocks = blocks_for(M, N, sms)
    part = torch.empty((M, blocks, D + 2), dtype=torch.float32,
                       device=d2u.device)
    vec = N % 4 == 0 and d2u.data_ptr() % 16 == 0 \
        and inner.data_ptr() % 16 == 0
    with torch.cuda.device(d2u.device):
        stream = torch.cuda.current_stream(d2u.device).cuda_stream
        rc = lib.nll_grad_launch(d2u.data_ptr(), inner.data_ptr(),
                                 params.data_ptr(), part.data_ptr(),
                                 out.data_ptr(), M, N, D, blocks, int(vec),
                                 stream)
    if rc != 0:
        raise RuntimeError(f"nll_grad kernel launch failed: "
                           f"{lib.nll_grad_error_string(rc).decode()}")
    launches += 1
    return out


def nll_grad(d2u, inner, params, K=None):
    """d2u (M, D, N, N), inner (M, N, N), params (M, D+1) -> (M, D+2).

    CPU tensors run the plain version in their dtype (reusing `K` when
    given); tensors on any other device go to the CUDA kernel, which
    rebuilds K in registers (so `K` is ignored there), takes float32,
    contiguous inputs on one CUDA device and raises on anything else."""
    if d2u.device.type == "cpu":
        return nll_grad_plain(d2u, inner, params, K)
    return _launch(d2u, inner, params)
