"""Fused RBF Gram-matrix x vector product over a fleet of experts.

    out[m, q] = sf2 * sum_j exp(-||a_q - b_{m,j}||^2) v[m, j]

for queries a (Nt, D) and agent inputs b (M, Ni, D), both pre-scaled by
1/lengthscale, weights v (M, Ni) and sf2 = sigma_f^2 -> (M, Nt): every
agent's streamed posterior mean k(Xs, X_m) alpha_m without forming the
Gram. It replaces the Pallas kernel `repro/kernels/rbf_matvec.py:
rbf_matvec_pallas`, which the reference vmaps over agents; here one launch
covers the whole fleet.

`rbf_matvec` dispatches on where its tensors lie. On the CPU it runs
`rbf_matvec_plain`, the plain PyTorch version, in the input dtype. On a
CUDA device it launches the hand-written kernel `csrc/rbf_matvec.cu`
(float32) or raises: there is no fallback to the plain version on the
card. `launches` counts kernel launches, so a run can show that its path
went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

#: kernel launches since import or the last `reset_launches()`
launches = 0

_SPLIT_WAVES = 2          # aim for this many blocks per SM
_QUERIES_PER_BLOCK = 128  # kThreads in csrc/rbf_matvec.cu


def reset_launches() -> None:
    global launches
    launches = 0


def rbf_matvec_plain(a, b, v, sf2):
    """Plain PyTorch version of the kernel, in the input dtype.

    Direct differences like the kernel, one input dimension at a time, so
    the transient is one (M, Nt, Ni) array."""
    d2 = torch.zeros((b.shape[0], a.shape[0], b.shape[1]), dtype=a.dtype,
                     device=a.device)
    for d in range(a.shape[1]):
        d2 += (a[None, :, None, d] - b[:, None, :, d]) ** 2
    return sf2 * torch.einsum("mqj,mj->mq", torch.exp(-d2), v)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("rbf_matvec")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rbf_matvec_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                      i32, i32, i32, i32, i32, ptr]
    lib.rbf_matvec_launch.restype = i32
    lib.rbf_matvec_tile.argtypes = [i32]
    lib.rbf_matvec_tile.restype = i32
    lib.rbf_matvec_error_string.argtypes = [i32]
    lib.rbf_matvec_error_string.restype = ctypes.c_char_p
    return lib


def _check(a, b, v, sf2):
    """Raise unless the inputs are what the kernel takes: float32,
    contiguous, a (Nt, D), b (M, Ni, D), v (M, Ni), sf2 (1,), all on the
    CUDA device of a."""
    tensors = {"a": a, "b": b, "v": v, "sf2": sf2}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"rbf_matvec kernel: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rbf_matvec kernel: {name} must be "
                             f"contiguous")
    if a.dim() != 2 or b.dim() != 3 or v.dim() != 2 or sf2.numel() != 1 \
            or b.shape[2] != a.shape[1] or v.shape != b.shape[:2]:
        raise ValueError(f"rbf_matvec kernel: want a (Nt, D), b (M, Ni, D), "
                         f"v (M, Ni), sf2 (1,); got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(v.shape)}, "
                         f"{tuple(sf2.shape)}")
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"rbf_matvec kernel: {name} must lie on the "
                             f"CUDA device of a, got {t.device}")


def splits_for(Nt: int, M: int, Ni: int, sm_count: int) -> int:
    """Blocks to split each agent's Ni points over, so that a query tile
    fills the card: about `_SPLIT_WAVES` blocks per SM, never more splits
    than there are 256-point stages."""
    qblocks = -(-Nt // _QUERIES_PER_BLOCK)
    want = -(-_SPLIT_WAVES * sm_count // (qblocks * M))
    return max(1, min(want, -(-Ni // 256)))


def _launch(a, b, v, sf2):
    global launches
    _check(a, b, v, sf2)
    Nt, D = a.shape
    M, Ni = v.shape
    out = torch.empty((M, Nt), dtype=torch.float32, device=a.device)
    if Nt == 0 or M == 0:
        return out
    lib = _library()
    if lib.rbf_matvec_tile(D) == 0:
        raise ValueError(f"rbf_matvec kernel: input dimension D={D} does "
                         f"not fit one shared-memory stage")
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    splits = splits_for(Nt, M, Ni, sms)
    part = (torch.empty((splits, M, Nt), dtype=torch.float32,
                        device=a.device) if splits > 1 else None)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.rbf_matvec_launch(
            a.data_ptr(), b.data_ptr(), v.data_ptr(), sf2.data_ptr(),
            None if part is None else part.data_ptr(), out.data_ptr(),
            Nt, M, Ni, D, splits, stream)
    if rc != 0:
        raise RuntimeError(f"rbf_matvec kernel launch failed: "
                           f"{lib.rbf_matvec_error_string(rc).decode()}")
    launches += 1
    return out


def rbf_matvec(a, b, v, sf2):
    """a (Nt, D), b (M, Ni, D), v (M, Ni), sf2 (1,) -> (M, Nt).

    CPU tensors run the plain version in their dtype; tensors on any other
    device go to the CUDA kernel, which takes float32, contiguous inputs on
    one CUDA device and raises on anything else."""
    if a.device.type == "cpu":
        return rbf_matvec_plain(a, b, v, sf2.reshape(()))
    return _launch(a, b, v, sf2)
