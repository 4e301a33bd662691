"""The program's layer spans on the traced slice's timeline: the helper of
the `program_span` readers that split device time and idle time by layer.

The program records its spans (`repro_torch.obs.tracing.span`) while the
profiler records, in Unix ns (the trace's clock) on OS thread ids. Each
thread's probe (an empty `record_function` range named `<PROBE>#<os
tid>#<index>`) gives the profiler's number of that OS thread. Then

  device seconds  each kernel, copy and fill of the slice goes, through
                  its runtime call's correlation id, under the innermost
                  span open on the thread that made the call at that
                  moment (and under every span enclosing that one);
  idle seconds    the slice [t0, t0 + window_s] less the union of its
                  device activities, clipped to it, is cut piecewise by
                  the innermost span open on the thread that launched
                  most of the slice's device time.

What finds no span is unattributed: the remainder of the slice's device
total (the sum of its activities, `readings.device_total`) and of its
clipped idle seconds, so attributed and unattributed add up to both
exactly. `trace.py`'s idle (window_s - busy_s) counts the union of the
activities unclipped; the difference between the two idles is reported
beside the split (`idle_off_trace_s`), as is how far a probe's own
clock read lies outside its trace range (`clock_skew_us`, 0 when the
program's clock is the trace's). Every reader returns None on a slice
with no device activity (the CPU) or no probe (a program without spans).
The second module of the benchmark that imports the program, besides
`program.py`.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

from gpbench.readings import percent
from gpbench.trace import LABEL, STEP

INF = float("inf")


def _recorder():
    """The program's span module, or None where the program has none."""
    try:
        from repro_torch.obs import tracing
    except ImportError:
        return None
    return tracing if hasattr(tracing, "drain") else None


def idle_key(rec) -> str:
    """The idle split's key of a span: its name; the front door's wait
    split into the batching hold (rows pending) and no work."""
    if rec.name == "frontdoor.wait":
        return ("frontdoor.wait:hold" if rec.fields.get("pending", 0) > 0
                else "frontdoor.wait:no_work")
    return rec.name


def flatten(records):
    """One thread's spans (properly nested in time) -> sorted disjoint
    (start, end, innermost record, names of it and its ancestors) over
    the time some span is open; an open span (`end` None) lasts on."""
    items = sorted(records, key=lambda r: (
        r.start, -(INF if r.end is None else r.end)))
    out, stack, cur = [], [], None

    def emit(a, b, frame):
        if b > a:
            out.append((a, b, frame[1], frame[2]))

    for r in items:
        while stack and stack[-1][0] <= r.start:
            top = stack.pop()
            emit(cur, top[0], top)
            cur = top[0]
        end = INF if r.end is None else r.end
        if stack:
            emit(cur, r.start, stack[-1])
            end = min(end, stack[-1][0])
            path = stack[-1][2] | {r.name}
        else:
            path = frozenset((r.name,))
        cur = r.start
        stack.append((end, r, path))
    while stack:
        top = stack.pop()
        emit(cur, top[0], top)
        cur = top[0]
    return out


def _segments(dev):
    segs = []
    for s, e, _ in sorted(dev):
        if segs and s <= segs[-1][1]:
            segs[-1][1] = max(segs[-1][1], e)
        else:
            segs.append([s, e])
    return segs


def _clip(segs, t0, t1):
    """The device segments' parts inside [t0, t1]."""
    return [(max(s, t0), min(e, t1)) for s, e in segs if e > t0 and s < t1]


def _gaps(segs, t0, t1):
    """Idle intervals of [t0, t1] outside the (clipped, sorted, disjoint)
    device segments."""
    gaps, cur = [], t0
    for s, e in segs:
        if s > cur:
            gaps.append((cur, s))
        cur = e
    if cur < t1:
        gaps.append((cur, t1))
    return gaps


def _events(events, probe):
    """The raw profiler events -> device activities (start, end, corr),
    runtime calls {corr: (time, thread)}, probe ranges {name: (start,
    end, thread)} and the device events named like a program span."""
    from torch.autograd import DeviceType
    dev, runtime, probes, device_names = [], {}, {}, []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name.startswith((LABEL, STEP)):
                continue          # the device image of a harness range
            s = e.start_ns()
            dev.append((s, s + e.duration_ns(), e.correlation_id()))
            device_names.append(name)
        elif name.startswith(probe + "#"):
            s = e.start_ns()
            probes[name] = (s, s + e.duration_ns(), e.start_thread_id())
        elif name.startswith("cu"):
            runtime.setdefault(e.correlation_id(),
                               (e.start_ns(), e.start_thread_id()))
    return dev, runtime, probes, device_names


def attribute(events, records, probe: str, t0_ns: int, window_s: float,
              busy_s: float):
    """Split the slice [t0_ns, + window_s] (Unix ns) by span, or None (no
    device activity, or no probe of the program in the trace). `busy_s`
    is trace.py's, for the difference between the two idles."""
    dev, runtime, probe_ev, device_names = _events(events, probe)
    if not dev:
        return None
    spans, os_of, skew = defaultdict(list), {}, 0
    for r in records:
        if r.name.startswith(probe + "#"):
            ev = probe_ev.get(r.name)
            if ev is not None:
                os_of[ev[2]] = r.tid
                skew = max(skew, ev[0] - r.start, r.start - ev[1])
        elif r.start is not None:
            spans[r.tid].append(r)
    if not os_of:
        return None
    flat = {}
    for tid, recs in spans.items():
        segs = flatten(recs)
        flat[tid] = (segs, [s[0] for s in segs])

    def innermost(tid, t):
        segs, starts = flat.get(tid, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < segs[i][1]:
            return segs[i]
        return None

    device_s, under_s = defaultdict(float), defaultdict(float)
    launched = defaultdict(float)
    total = 0.0
    for s, e, corr in dev:
        dt = (e - s) * 1e-9
        total += dt
        call = runtime.get(corr)
        if call is None:
            continue
        launched[call[1]] += dt
        seg = innermost(os_of.get(call[1]), call[0])
        if seg is not None:
            device_s[seg[2].name] += dt
            for name in seg[3]:
                under_s[name] += dt
    launcher = os_of.get(max(launched, key=launched.get)) \
        if launched else None

    t1 = t0_ns + round(window_s * 1e9)
    gaps = _gaps(_clip(_segments(dev), t0_ns, t1), t0_ns, t1)
    idle_ns = defaultdict(int)
    segs = flat.get(launcher, ((), ()))[0]
    j = 0
    for a, b in gaps:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            overlap = min(b, segs[k][1]) - max(a, segs[k][0])
            if overlap > 0:
                idle_ns[idle_key(segs[k][2])] += overlap
            k += 1
    idle_total = sum(b - a for a, b in gaps)
    idle_ns["unattributed"] = idle_total - sum(idle_ns.values())
    device_s["unattributed"] = total - sum(device_s.values())
    names = {r.name for r in records}
    return {"idle_s": {k: v * 1e-9 for k, v in idle_ns.items()},
            "device_s": dict(device_s), "under_s": dict(under_s),
            "device_total_s": total, "idle_total_s": idle_total * 1e-9,
            "idle_off_trace_s": idle_total * 1e-9 - (window_s - busy_s),
            "window_s": window_s, "launch_tid": launcher,
            "probes": len(os_of), "clock_skew_us": skew * 1e-3,
            "records": sum(len(r) for r in spans.values()),
            "span_images": sum(n in names for n in device_names)}


def split(run):
    """The traced slice's split by span, computed once a run (the first
    reader drains the program's recorder); None where there is nothing to
    read. Its whole split goes into `run.layer["spans"]`, which the
    harness prints with the readings."""
    if hasattr(run, "span_split"):
        return run.span_split
    run.span_split = None
    tracing = _recorder()
    prof = run.profiler
    if tracing is None or prof is None or prof.events is None \
            or "trace" not in run.layer:
        return None
    records, dropped = tracing.drain()
    tr = run.layer["trace"]
    # the slice opened at perf_counter prof._t0: on the Unix clock
    t0 = round(prof._t0 * 1e9) + time.time_ns() - time.perf_counter_ns()
    out = attribute(prof.events, records, tracing.PROBE, t0,
                    tr["window_s"], tr["busy_s"])
    if out is None:
        return None
    out["dropped"] = dropped
    run.span_split = out
    run.layer["spans"] = {
        "idle_s": out["idle_s"], "device_s": out["device_s"],
        "attributed_device_share": percent(
            out["device_total_s"] - out["device_s"]["unattributed"],
            out["device_total_s"]),
        "idle_off_trace_s": out["idle_off_trace_s"],
        "clock_skew_us": out["clock_skew_us"], "records": out["records"],
        "probes": out["probes"], "dropped": dropped,
        "span_images": out["span_images"]}
    return out


def device_share(run, name: str):
    """Device seconds under span `name` over all device seconds of the
    slice, in %."""
    s = split(run)
    if s is None:
        return None
    return percent(s["under_s"].get(name, 0.0), s["device_total_s"])


def idle_share(run, keep):
    """Idle seconds whose innermost span's `idle_key` passes `keep`, over
    the slice, in %."""
    s = split(run)
    if s is None:
        return None
    return percent(sum(v for k, v in s["idle_s"].items()
                       if k != "unattributed" and keep(k)), s["window_s"])
