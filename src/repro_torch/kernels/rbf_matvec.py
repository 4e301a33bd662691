"""Fused RBF Gram-matrix x vector product over a fleet of experts.

    out[m, q] = sf2 * sum_j exp(-sum_d ((a_qd - b_mjd) / l_d)^2) v[m, j]

for queries a (Nt, D), agent inputs b (M, Ni, D), weights v (M, Ni),
lengthscales l (D,) and sf2 (1,) = sigma_f^2 -> (M, Nt): every agent's
streamed posterior mean k(Xs, X_m) alpha_m without forming the Gram. It
replaces the Pallas kernel `repro/kernels/rbf_matvec.py:
rbf_matvec_pallas`, which the reference vmaps over agents; here one launch
covers the whole fleet, and the kernel scales the inputs by 1/l itself.

`rbf_matvec` dispatches on where its tensors lie. On the CPU it runs
`rbf_matvec_plain`, the plain PyTorch version, in the input dtype. On a
CUDA device it launches the hand-written kernel `csrc/rbf_matvec.cu`
(float32) or raises: there is no fallback to the plain version on the
card. `launches` counts kernel launches, so a run can show that its path
went through the kernel.

The kernel's launch geometry is `geometry`: clusters of `splits` blocks
share one agent's points for one tile of `QUERIES_PER_BLOCK` queries and
sum their partials in rank order inside the launch.
"""
from __future__ import annotations

import ctypes
import threading
import functools
from typing import NamedTuple

import torch

from . import _build

#: kernel launches since import or the last `reset_launches()`
launches = 0
# `launches += 1` is a read-modify-write: serving threads (a scheduler's
# worker, a watchdog's second worker) may launch at once
_launches_lock = threading.Lock()

# the compile-time geometry of csrc/rbf_matvec.cu (checked at load)
THREADS = 128                 # kThreads: threads of a block
LANES = 16                    # kLanes: point lanes of a query group
QUERIES_PER_THREAD = 2        # kQ
STAGE = 1024                  # kStageMax: points a stage, at most
MAX_SPLITS = 8                # kMaxSplits: the portable cluster size
QUERIES_PER_BLOCK = THREADS // LANES * QUERIES_PER_THREAD
CHUNK = 4 * LANES             # points of one chunk step of the lanes
_BUFFERS = 3                  # kBuffers: the cp.async ring
_SMEM_FLOATS = 47 * 1024 // 4  # kSmemBudget: 48 KB less the static 1 KB
_BLOCKS_PER_SM = 4            # aim for this many blocks per SM


class Geometry(NamedTuple):
    """One launch: grid (splits, query_tiles, M), clusters of `splits`
    blocks along the first axis; block (rank, t, m) takes queries
    [t QUERIES_PER_BLOCK, (t + 1) QUERIES_PER_BLOCK) and agent m's points
    [rank per_split, (rank + 1) per_split), clipped to Nt and Ni, in
    stages of `stage` points."""
    splits: int
    query_tiles: int
    per_split: int
    stage: int
    blocks: int


def stage_points(D: int) -> int:
    """Points a stage for input dimension D (rbf_matvec_stage in the
    source): STAGE while three stages of (D + 1) floats a point and the
    block's queries fit 47 KB (48 KB less the kernel's static shared
    memory), fewer whole chunk rows above that; 0 when D does not fit one
    stage."""
    if not 1 <= D <= 64:
        return 0
    floats = _SMEM_FLOATS - QUERIES_PER_BLOCK * D
    return min(STAGE, floats // (_BUFFERS * (D + 1)) // CHUNK * CHUNK)


def geometry(Nt: int, M: int, Ni: int, D: int, sm_count: int) -> Geometry:
    """Launch geometry at these shapes on a card of `sm_count` SMs: enough
    splits for about `_BLOCKS_PER_SM` blocks an SM, at most MAX_SPLITS (the
    cluster) and at most one per CHUNK points, so every split walks at
    least one chunk row."""
    qtiles = -(-Nt // QUERIES_PER_BLOCK)
    clusters = max(1, qtiles * M)
    cap = max(1, min(MAX_SPLITS, Ni // CHUNK))
    splits = max(1, min(cap, -(-_BLOCKS_PER_SM * sm_count // clusters)))
    return Geometry(splits, qtiles, -(-Ni // splits), stage_points(D),
                    splits * qtiles * M)


def reset_launches() -> None:
    global launches
    launches = 0


def rbf_matvec_plain(a, b, v, ls, sf2):
    """Plain PyTorch version of the kernel, in the input dtype.

    Direct differences of the inputs scaled by 1/l, one input dimension
    at a time, so the transient is one (M, Nt, Ni) array."""
    a, b = a / ls, b / ls
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
    lib.rbf_matvec_stage.argtypes = [i32]
    lib.rbf_matvec_stage.restype = i32
    lib.rbf_matvec_constants.argtypes = [ptr]
    lib.rbf_matvec_constants.restype = None
    lib.rbf_matvec_error_string.argtypes = [i32]
    lib.rbf_matvec_error_string.restype = ctypes.c_char_p
    built = (ctypes.c_int * 5)()
    lib.rbf_matvec_constants(ctypes.addressof(built))
    want = (THREADS, LANES, QUERIES_PER_THREAD, STAGE, MAX_SPLITS)
    if tuple(built) != want:
        raise RuntimeError(f"rbf_matvec kernel built with geometry "
                           f"{tuple(built)}, the wrapper expects {want}")
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(a, b, v, ls, sf2):
    """Raise unless the inputs are what the kernel takes: float32,
    contiguous, a (Nt, D), b (M, Ni, D), v (M, Ni), ls (D,), sf2 (1,), all
    on the CUDA device of a."""
    tensors = {"a": a, "b": b, "v": v, "ls": ls, "sf2": sf2}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"rbf_matvec kernel: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rbf_matvec kernel: {name} must be "
                             f"contiguous")
    if a.dim() != 2 or b.dim() != 3 or v.dim() != 2 or ls.dim() != 1 \
            or sf2.numel() != 1 or b.shape[2] != a.shape[1] \
            or ls.shape[0] != a.shape[1] or v.shape != b.shape[:2]:
        raise ValueError(f"rbf_matvec kernel: want a (Nt, D), b (M, Ni, D), "
                         f"v (M, Ni), ls (D,), sf2 (1,); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(v.shape)}, {tuple(ls.shape)}, "
                         f"{tuple(sf2.shape)}")
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"rbf_matvec kernel: {name} must lie on the "
                             f"CUDA device of a, got {t.device}")


def _launch(a, b, v, ls, sf2):
    global launches
    _check(a, b, v, ls, sf2)
    Nt, D = a.shape
    M, Ni = v.shape
    out = torch.empty((M, Nt), dtype=torch.float32, device=a.device)
    if Nt == 0 or M == 0:
        return out
    lib = _library()
    if lib.rbf_matvec_stage(D) == 0:
        raise ValueError(f"rbf_matvec kernel: input dimension D={D} does "
                         f"not fit one shared-memory stage")
    index = a.device.index
    g = geometry(Nt, M, Ni, D, _sm_count(index))
    args = (a.data_ptr(), b.data_ptr(), v.data_ptr(), ls.data_ptr(),
            sf2.data_ptr(), out.data_ptr(), Nt, M, Ni, D, g.splits,
            torch.cuda.current_stream(a.device).cuda_stream)
    if index == torch.cuda.current_device():
        rc = lib.rbf_matvec_launch(*args)
    else:
        with torch.cuda.device(index):
            rc = lib.rbf_matvec_launch(*args)
    if rc != 0:
        raise RuntimeError(f"rbf_matvec kernel launch failed: "
                           f"{lib.rbf_matvec_error_string(rc).decode()}")
    with _launches_lock:
        launches += 1
    return out


def rbf_matvec(a, b, v, ls, sf2):
    """a (Nt, D), b (M, Ni, D), v (M, Ni), ls (D,), sf2 (1,) -> (M, Nt).

    CPU tensors run the plain version in their dtype; tensors on any other
    device go to the CUDA kernel, which takes float32, contiguous inputs on
    one CUDA device and raises on anything else."""
    if a.device.type == "cpu":
        return rbf_matvec_plain(a, b, v, ls, sf2.reshape(()))
    return _launch(a, b, v, ls, sf2)
