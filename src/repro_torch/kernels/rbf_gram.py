"""Tiled squared-exponential Gram panels over a fleet of sparse experts.

    out[a, i, j] = sf2 * exp(-||z_{a,i} - x_{a,col0+j}||^2)
                   (+ noise2 where i == col0 + j, with_noise only)

for inducing inputs z (M, m, D) and agent inputs x (M, N, D), both
pre-scaled by 1/lengthscale, params (2,) = (sigma_f^2, noise^2), and the
`width` columns starting at `col0` -> (M, m, width). Columns past an
agent's N points are exactly 0, so the tail panel of a streamed
Kmn = k(Z, X) adds nothing to B = Kmn Knm or b = Kmn y
(ops.kmn_stats_agents). It replaces the Pallas kernel
`repro/kernels/rbf_gram.py:rbf_gram_pallas`, which the reference vmaps
over agents; here one launch covers the whole fleet's panel.

`rbf_gram` dispatches on where its tensors lie. On the CPU it runs
`rbf_gram_plain`, the plain PyTorch version, in the input dtype. On a CUDA
device it launches the hand-written kernel `csrc/rbf_gram.cu` (float32) or
raises: there is no fallback to the plain version on the card. `launches`
counts kernel launches, so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

import ctypes
import threading
import functools

import torch

from . import _build

#: kernel launches since import or the last `reset_launches()`
launches = 0
# `launches += 1` is a read-modify-write: serving threads (a scheduler's
# worker, a watchdog's second worker) may launch at once
_launches_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    launches = 0


def _width(x, col0, width):
    return x.shape[1] - col0 if width is None else int(width)


def rbf_gram_plain(z, x, params, with_noise: bool = False, col0: int = 0,
                   width: int | None = None):
    """Plain PyTorch version of the kernel, in the input dtype.

    Direct differences like the kernel, one input dimension at a time;
    columns past N come back exactly 0."""
    width = _width(x, col0, width)
    xs = x[:, col0:col0 + width]
    d2 = torch.zeros((z.shape[0], z.shape[1], xs.shape[1]), dtype=z.dtype,
                     device=z.device)
    for d in range(z.shape[2]):
        d2 += (z[:, :, None, d] - xs[:, None, :, d]) ** 2
    K = params[0] * torch.exp(-d2)
    if with_noise:
        rows = torch.arange(z.shape[1], device=z.device)
        cols = col0 + torch.arange(xs.shape[1], device=z.device)
        K = K + params[1] * (rows[:, None] == cols[None, :]).to(K.dtype)
    if xs.shape[1] < width:
        K = torch.nn.functional.pad(K, (0, width - xs.shape[1]))
    return K


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("rbf_gram")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rbf_gram_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                    i32, i32, i32, ptr]
    lib.rbf_gram_launch.restype = i32
    lib.rbf_gram_max_dim.argtypes = []
    lib.rbf_gram_max_dim.restype = i32
    lib.rbf_gram_error_string.argtypes = [i32]
    lib.rbf_gram_error_string.restype = ctypes.c_char_p
    return lib


def _check(z, x, params, col0, width):
    """Raise unless the inputs are what the kernel takes: float32,
    contiguous, z (M, m, D), x (M, N, D), params (2,), 0 <= col0 <= N,
    width >= 0, all on the CUDA device of z."""
    tensors = {"z": z, "x": x, "params": params}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"rbf_gram kernel: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rbf_gram kernel: {name} must be contiguous")
    if z.dim() != 3 or x.dim() != 3 or params.shape != (2,) \
            or x.shape[0] != z.shape[0] or x.shape[2] != z.shape[2] \
            or not 0 <= col0 <= x.shape[1] or width < 0:
        raise ValueError(f"rbf_gram kernel: want z (M, m, D), x (M, N, D), "
                         f"params (2,), 0 <= col0 <= N, width >= 0; got "
                         f"{tuple(z.shape)}, {tuple(x.shape)}, "
                         f"{tuple(params.shape)}, col0={col0}, "
                         f"width={width}")
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != z.device:
            raise ValueError(f"rbf_gram kernel: {name} must lie on the "
                             f"CUDA device of z, got {t.device}")


def _launch(z, x, params, with_noise, col0, width):
    global launches
    _check(z, x, params, col0, width)
    M, m, D = z.shape
    out = torch.empty((M, m, width), dtype=torch.float32, device=z.device)
    if out.numel() == 0:
        return out
    lib = _library()
    if D > lib.rbf_gram_max_dim():
        raise ValueError(f"rbf_gram kernel: input dimension D={D} does not "
                         f"fit one shared-memory tile")
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        rc = lib.rbf_gram_launch(z.data_ptr(), x.data_ptr(),
                                 params.data_ptr(), out.data_ptr(), M, m,
                                 x.shape[1], D, int(col0), width,
                                 int(bool(with_noise)), stream)
    if rc != 0:
        raise RuntimeError(f"rbf_gram kernel launch failed: "
                           f"{lib.rbf_gram_error_string(rc).decode()}")
    with _launches_lock:
        launches += 1
    return out


def rbf_gram(z, x, params, with_noise: bool = False, col0: int = 0,
             width: int | None = None):
    """z (M, m, D), x (M, N, D), params (2,) -> (M, m, width) (default
    width: the columns from col0 to N).

    CPU tensors run the plain version in their dtype; tensors on any other
    device go to the CUDA kernel, which takes float32, contiguous inputs on
    one CUDA device and raises on anything else."""
    width = _width(x, col0, width)
    if z.device.type == "cpu":
        return rbf_gram_plain(z, x, params, with_noise, col0, width)
    return _launch(z, x, params, with_noise, col0, width)
