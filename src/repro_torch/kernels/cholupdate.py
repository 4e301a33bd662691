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
(float32; DEVICE_LAUNCHES_PER_CALL = 2 device launches per call: the fill
of its scratch and one persistent wavefront kernel) or raises: there is
no fallback to the plain version on the card. `launches` counts calls
that launched the kernel, so a run can show that its path went through
it.

The kernel's watchdog reports a panel that never arrived (a scheduling
fault) in a 4-byte word, which the wrapper copies to pinned host memory
without waiting. The next call, and `check_faults()`, which waits for
every call still pending, raise RuntimeError for it: the hot path never
stalls the host on the card, and a fault surfaces at most one call late.

`schedule` is the kernel's work list, computed here for the scratch sizes
and the input checks: per agent, ceil((n - s) / 32) strips of 32 rows,
strip q producing panel q's rotations (one scratch record per (agent,
panel), which is its own ready flag), and ceil(s / 32) strips of stale
rows. The kernel hands strips out by ticket: ticket q * M + a is strip q
of agent a, and the stale strips follow all of them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

#: kernel calls since import or the last `reset_launches()`
launches = 0
#: calls whose fault word is not yet read: (event after its copy, the
#: pinned word, panels per agent, watchdog seconds)
_pending: list = []
#: rows per strip = columns per panel (one warp, a lane per row)
STRIP = 32
#: device launches per kernel call: the fill of the scratch, the kernel
DEVICE_LAUNCHES_PER_CALL = 2
#: int32 words of a scratch record: a panel's 32 rotations (c, s / c,
#: sign s, on), each word -1 (all ones) until it is published
RECORD_WORDS = STRIP * 4
#: seconds a strip waits for a panel before the kernel reports a fault
WATCHDOG_S = 2.0
#: tickets the kernel's int32 counter can hand out, less one per block
#: (each draws one past the last before it exits)
MAX_TICKETS = 2**31 - 1 - 2**16


class Schedule(NamedTuple):
    """The kernel's work list for M agents, n rows, shift s."""
    M: int
    panels: int    # per agent: ceil((n - s) / 32), one strip each
    stale: int     # per agent: ceil(s / 32) strips of stale rows
    tickets: int   # M * (panels + stale)
    records: int   # one per (agent, panel)

    @property
    def scratch_words(self) -> int:
        """int32 words of the kernel's scratch: the records, the ticket
        counter and the fault word."""
        return self.records * RECORD_WORDS + 2


def schedule(M: int, n: int, shift: int) -> Schedule:
    """The kernel's strips for (M, n, n) factors and `shift`; raises
    ValueError past the ticket counter's range."""
    panels, stale = -(-(n - shift) // STRIP), -(-shift // STRIP)
    tickets = M * (panels + stale)
    if tickets > MAX_TICKETS:
        raise ValueError(f"cholupdate kernel: M * (ceil((n - shift) / "
                         f"{STRIP}) + ceil(shift / {STRIP})) = {tickets} "
                         f"strips exceed the ticket counter's range "
                         f"({MAX_TICKETS})")
    return Schedule(M, panels, stale, tickets, M * panels)


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
    i64 = ctypes.c_longlong
    lib.cholupdate_launch.argtypes = [ptr, ptr, ptr, i64, i64, ptr, ptr,
                                      i32, i32, i32, i32, i64, i32, ptr]
    lib.cholupdate_launch.restype = i32
    lib.cholupdate_selfcheck.argtypes = [ctypes.c_ulonglong, ptr, ptr]
    lib.cholupdate_selfcheck.restype = i32
    lib.cholupdate_error_string.argtypes = [i32]
    lib.cholupdate_error_string.restype = ctypes.c_char_p
    return lib


def _check(L, x, shift, active):
    """Raise unless the inputs are what the kernel takes: L float32,
    contiguous (M, n, n); x float32 (M, n), any strides; active None or
    bool (M,); 0 <= shift <= n; no more strips than the ticket counter
    holds; all on the CUDA device of L."""
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
    schedule(L.shape[0], L.shape[-1], shift)
    for name, t in (("L", L), ("x", x), ("active", active)):
        if t is not None and (t.device.type != "cuda"
                              or t.device != L.device):
            raise ValueError(f"cholupdate kernel: {name} must lie on the "
                             f"CUDA device of L, got {t.device}")


def selfcheck(n_div: int, device="cuda") -> dict:
    """Hold the kernel's branch-free division and square root to
    __fdiv_rn and __fsqrt_rn on the card, bit for bit: every float in the
    square root's fast range and `n_div` pseudo-random divisions. Returns
    the counts checked and unequal."""
    counts = torch.zeros(4, dtype=torch.int64, device=device)
    lib = _library()
    with torch.cuda.device(counts.device):
        rc = lib.cholupdate_selfcheck(
            int(n_div), counts.data_ptr(),
            torch.cuda.current_stream(counts.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cholupdate self-check launch failed: "
                           f"{lib.cholupdate_error_string(rc).decode()}")
    sq, sq_bad, dv, dv_bad = counts.tolist()
    return {"sqrt_checked": sq, "sqrt_unequal": sq_bad,
            "div_checked": dv, "div_unequal": dv_bad}


def check_faults(wait: bool = True) -> None:
    """Raise RuntimeError if the watchdog of an earlier kernel call fired
    (its result is void). With `wait`, wait for every call still pending;
    without, look only at the calls the device has finished."""
    global _pending
    pending, _pending = _pending, []
    for i, (done, word, panels, timeout_s) in enumerate(pending):
        if wait:
            done.synchronize()
        elif not done.query():
            _pending.append(pending[i])
            continue
        fault = int(word[0])
        if fault != -1:
            _pending += pending[i + 1:]
            agent, panel = divmod(fault, panels)
            raise RuntimeError(f"cholupdate kernel: the rotations of panel "
                               f"{panel} of agent {agent} never arrived "
                               f"within {timeout_s} s (watchdog); that "
                               f"call's result is void")


def _launch(L, x, downdate, shift, active, timeout_s=WATCHDOG_S,
            never_publish=-1):
    """Launch the kernel; `timeout_s` and `never_publish` (agent 0's panel
    whose rotations are withheld) exist so that a test can trip the
    watchdog."""
    global launches
    _check(L, x, shift, active)
    check_faults(wait=False)
    M, n, _ = L.shape
    out = torch.empty_like(L)
    if M == 0 or n == 0:
        return out
    lib = _library()
    sched = schedule(M, n, shift)
    # records unpublished, the ticket counter before the first ticket, no
    # fault: all -1
    scratch = torch.full((sched.scratch_words,), -1, dtype=torch.int32,
                         device=L.device)
    act = None if active is None else active.contiguous()
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream(L.device).cuda_stream
        rc = lib.cholupdate_launch(L.data_ptr(), out.data_ptr(),
                                   x.data_ptr(), x.stride(0), x.stride(1),
                                   None if act is None else act.data_ptr(),
                                   scratch.data_ptr(), M, n, int(shift),
                                   int(bool(downdate)),
                                   int(timeout_s * 1e9), int(never_publish),
                                   stream)
    if rc != 0:
        raise RuntimeError(f"cholupdate kernel launch failed: "
                           f"{lib.cholupdate_error_string(rc).decode()}")
    launches += 1
    # the kernel may still run when this returns: `scratch` (and a copy of
    # `active`) go back to PyTorch's caching allocator, which hands their
    # blocks out again only in the stream's order, after the kernel; the
    # pinned word stays in _pending until it is read
    word = torch.empty(1, dtype=torch.int32, pin_memory=True)
    word.copy_(scratch[-1:], non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(L.device))
    _pending.append((done, word, sched.panels, timeout_s))
    return out


def cholupdate(L, x, downdate: bool = False, shift: int = 0, active=None):
    """L (M, n, n), x (M, n) -> the updated factors (M, n, n).

    CPU tensors run the plain version in their dtype; tensors on any other
    device go to the CUDA kernel, which takes float32 on one CUDA device
    and raises on anything else."""
    if L.device.type == "cpu":
        return cholupdate_plain(L, x, downdate, shift, active)
    return _launch(L, x, downdate, shift, active)
