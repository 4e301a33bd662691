"""Helpers of the per-layer readers (metrics/<name>.py): sums over the
traced slice's kernels and the shares the readers report."""
from __future__ import annotations


def kernel(run, key: str) -> tuple[float, int]:
    """(device seconds, launches) of the kernels whose name contains
    `key` in the traced slice."""
    tr = run.layer["trace"]
    names = [n for n in tr["kernel_s"] if key in n]
    return (sum(tr["kernel_s"][n] for n in names),
            sum(tr["kernel_n"][n] for n in names))


def device_total(run) -> float:
    """Device seconds of every activity in the traced slice (summed, not
    their union)."""
    return sum(run.layer["trace"]["kernel_s"].values())


def percent(part: float, whole: float):
    """100 part / whole, or None (nothing to read) when whole is 0."""
    return 100.0 * part / whole if whole > 0 else None


def roofline(run, key: str, bound_ms: float):
    """A kernel's share of its roofline: its launches' least time over
    their device time, in %; None when the slice launched it never."""
    seconds, n = kernel(run, key)
    return percent(n * bound_ms * 1e-3, seconds) if n else None


def idle(run):
    tr = run.layer["trace"]
    return percent(tr["window_s"] - tr["busy_s"], tr["window_s"])
