"""The traced slice of a `--trace 1` run: torch.profiler (CPU and CUDA
activities, one session for the run) over a few seconds of the cell's own
loop, reduced in memory from the profiler's raw events to

  busy_s        the union of device-activity intervals (kernels, copies,
                fills) in the slice,
  window_s      the slice's host-clock length,
  kernel_s      device seconds by kernel name (kernel_n: launches),
  op_device_s   device seconds of the kernels launched inside each named
                host operation (matched through the launch's correlation
                id and the host thread), e.g. aten::linalg_solve_triangular,
  gaps          the longest idle gaps between device activities, each with
                the host operations open at its midpoint.

The harness's own `record_function` labels ("gpbench:<step>") mark which
call of the program the host was in.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict


LABEL = "gpbench:"
STEP = "ProfilerStep#"              # the profiler's own range of the slice


def label(name: str):
    """A host span of the harness, visible in the trace."""
    import torch
    return torch.profiler.record_function(LABEL + name)


def _sync(cuda: bool):
    if cuda:
        import torch
        torch.cuda.synchronize()


class Profiler:
    """One torch.profiler session for the whole `--trace 1` run. It starts
    before set-up in its warm-up phase, so CUPTI's start-up (seconds) falls
    outside the window, records from `open` to `close`, and `stop` ends it.
    One session a process: a second session on the card has come back
    without the device's kernels. With `cuda=False` (the harness's tests
    on the CPU) it records host activity only."""

    def __init__(self, cuda: bool = True):
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile, schedule
        self.cuda = cuda
        self.events = None
        self.window_s = 0.0
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        # host ops of every thread: the front door serves from its worker
        self.prof = profile(
            activities=acts, on_trace_ready=self._ready,
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self.prof.start()

    def _ready(self, prof):
        self.events = prof.profiler.kineto_results.events()

    def open(self):
        _sync(self.cuda)
        self.prof.step()
        self._t0 = time.perf_counter()

    def close(self):
        _sync(self.cuda)
        self.window_s = time.perf_counter() - self._t0
        self.prof.step()

    def stop(self):
        self.prof.stop()

    def summary(self, ops=()) -> dict:
        from torch.autograd import DeviceType
        if self.events is None:
            raise RuntimeError("the traced slice never closed: the window "
                               "is shorter than trace_after_s")
        dev, runtime, host = [], [], []
        for e in self.events:
            name = e.name()
            if name.startswith(LABEL) or name.startswith(STEP):
                if e.device_type() == DeviceType.CUDA:
                    continue      # the device image of a host range
            if e.device_type() == DeviceType.CUDA:
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            name, e.correlation_id()))
            elif name.startswith(("cuda", "cu")) and "Launch" in name:
                runtime.append((e.start_ns(), e.start_thread_id(),
                                e.correlation_id()))
            elif not name.startswith(STEP):
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                             e.start_thread_id(), name))
        dev.sort()
        segs = []
        for s, e, _, _ in dev:
            if segs and s <= segs[-1][1]:
                segs[-1][1] = max(segs[-1][1], e)
            else:
                segs.append([s, e])
        busy_ns = sum(e - s for s, e in segs)
        kernel_s, kernel_n = defaultdict(float), defaultdict(int)
        by_corr = defaultdict(float)
        for s, e, name, corr in dev:
            kernel_s[name] += (e - s) * 1e-9
            kernel_n[name] += 1
            by_corr[corr] += (e - s) * 1e-9
        return {"busy_s": busy_ns * 1e-9, "window_s": self.window_s,
                "kernel_s": dict(kernel_s), "kernel_n": dict(kernel_n),
                "op_device_s": _op_device_s(ops, host, runtime, by_corr),
                "gaps": _gaps(segs, host)}


class Timed:
    """The profiled slice of a measured window, in `--trace 1` runs only:
    it opens once the window has run `after` seconds and closes once it
    has itself been open `seconds`. `poll(elapsed)` switches it as due and
    returns the seconds until its next switch."""

    def __init__(self, run, after: float, seconds: float):
        self.prof = run.profiler
        self.after, self.seconds = after, seconds
        self.state = "before"

    def poll(self, elapsed: float) -> float:
        if self.prof is None:
            return float("inf")
        if self.state == "before" and elapsed >= self.after:
            self.prof.open()
            self.state = "on"
        elif self.state == "on" and self.open_s() >= self.seconds:
            self.close()
        if self.state == "before":
            return self.after - elapsed
        if self.state == "on":
            return max(self.seconds - self.open_s(), 0.0)
        return float("inf")

    def open_s(self) -> float:
        return time.perf_counter() - self.prof._t0

    def close(self):
        if self.state == "on":
            self.prof.close()
            self.state = "done"

    def summary(self, ops=()) -> dict:
        return self.prof.summary(ops)


def _outermost(intervals):
    """Drop intervals nested inside another of the list (sorted by start)."""
    out = []
    for s, e in sorted(intervals):
        if out and s < out[-1][1]:
            continue
        out.append((s, e))
    return out


def _op_device_s(ops, host, runtime, by_corr) -> dict:
    """Device seconds of the kernels launched inside each host op of
    `ops` (outermost occurrences, per host thread)."""
    result = {}
    for op in ops:
        per_thread = defaultdict(list)
        for s, e, tid, name in host:
            if name == op:
                per_thread[tid].append((s, e))
        total = 0.0
        for tid, iv in per_thread.items():
            iv = _outermost(iv)
            starts = [s for s, _ in iv]
            for t, rtid, corr in runtime:
                if rtid != tid:
                    continue
                i = bisect.bisect_right(starts, t) - 1
                if i >= 0 and t <= iv[i][1]:
                    total += by_corr.get(corr, 0.0)
        result[op] = total
    return result


def _gaps(segs, host, keep: int = 10):
    """The `keep` longest idle gaps between device activities, each named
    by the host ops open at its midpoint (outermost > innermost)."""
    gaps = sorted(((segs[i + 1][0] - segs[i][1], segs[i][1], segs[i + 1][0])
                   for i in range(len(segs) - 1)), reverse=True)[:keep]
    out = []
    for length, a, b in gaps:
        mid = (a + b) // 2
        open_ = [(e - s, name) for s, e, _, name in host if s <= mid <= e]
        if open_:
            open_.sort()
            what = open_[-1][1] if len(open_) == 1 else \
                f"{open_[-1][1]} > {open_[0][1]}"
        else:
            what = "no host op open"
        out.append([what, length * 1e-9])
    return out


def breakdown(summary: dict, keep: int = 10) -> dict:
    ops = sorted(summary["kernel_s"].items(), key=lambda kv: -kv[1])[:keep]
    return {"device_ops": [[name[:160], s] for name, s in ops],
            "idle_gaps": summary["gaps"][:keep]}
