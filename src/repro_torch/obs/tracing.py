"""Request spans and layer spans.

Request spans: contiguous per-stage timing for scheduler requests.

A `Span` is created at `add_request` and advanced at each stage boundary
of the serving pipeline (queue -> pack -> dispatch -> device -> stitch).
`advance(stage, t)` charges `t - t_last` to `stage` and moves the marker,
so the stages tile the request's lifetime exactly: their sum IS the
end-to-end latency, by construction (the <= 5% acceptance bound in
docs/observability.md holds with zero slack). A request that streams
across several slots re-enters "queue" after each slot's "stitch" — the
inter-slot wait is queueing, and the accounting stays contiguous.

`SpanLog` is the JSONL sink: one line per finished request (see
docs/observability.md for the event schema), safe for concurrent emits.

Layer spans: `span(name, **fields)` around a call into one layer of the
program (front door, engine, consensus, trainer, streaming windows; the
names are listed in docs/observability.md). A span records only while the
process-wide `SpanRecorder` is switched on, by `enable()` or by a running
torch profiler; otherwise `span()` returns one shared no-op after reading
the two switches, with no clock read, no lock and no record. A record
holds its name, start and end in `time.time_ns()`, the OS thread id, its
index on that thread and its parent's (the span open around it there)
and small integer fields. Records go into a bounded ring per thread (the
oldest dropped and counted); `drain()` returns and clears them, and
`SpanRecord.event()` is the `SpanLog` line.

On a profiler trace: its timestamps are Unix ns too, so the spans lie on
its clock as recorded. Its threads are the profiler's own numbers, so
while a profiler records, the first span a thread opens after a drain
emits a probe, an empty `record_function` named
"repro_torch.obs#<os tid>#<index>", whose trace event gives the
profiler's number of that OS thread. A probe
encloses no launch, so no span puts a range of its own on the device
timeline.
"""
from __future__ import annotations

import json
import sys
import threading
import time
from collections import deque

__all__ = ["Span", "SpanLog", "read_spans", "SpanRecord", "SpanRecorder",
           "span", "enable", "disable", "drain", "PROBE"]

# canonical stage order of the scheduler pipeline (docs/observability.md)
STAGES = ("queue", "pack", "dispatch", "device", "stitch")


class Span:
    """Per-request stage accumulator (monotonic perf_counter timebase)."""
    __slots__ = ("name", "labels", "t_start", "t_last", "stages")

    def __init__(self, name: str, t: float | None = None, **labels):
        now = time.perf_counter() if t is None else t
        self.name = name
        self.labels = labels
        self.t_start = now
        self.t_last = now
        self.stages: dict[str, float] = {}

    def advance(self, stage: str, t: float | None = None) -> float:
        """Charge the time since the previous boundary to `stage`."""
        now = time.perf_counter() if t is None else t
        dt = now - self.t_last
        self.stages[stage] = self.stages.get(stage, 0.0) + dt
        self.t_last = now
        return dt

    @property
    def elapsed(self) -> float:
        return self.t_last - self.t_start

    def event(self, outcome: str = "ok", **extra) -> dict:
        """The JSONL record for this span (times in ms)."""
        return {
            "event": "request",
            "span": self.name,
            **self.labels,
            "outcome": outcome,
            "e2e_ms": self.elapsed * 1e3,
            "stages_ms": {k: v * 1e3 for k, v in self.stages.items()},
            **extra,
        }


class SpanLog:
    """Append-only JSONL event sink, one `json.dumps` line per emit.

    Accepts a path (opened append) or any object with `write`. `emit` is
    thread-safe; `close` flushes and closes owned files only.
    """

    def __init__(self, path_or_file):
        self._lock = threading.Lock()
        if hasattr(path_or_file, "write"):
            self._fh = path_or_file
            self._owned = False
            self.path = getattr(path_or_file, "name", None)
        else:
            self.path = str(path_or_file)
            self._fh = open(self.path, "a")
            self._owned = True

    def emit(self, event: dict):
        line = json.dumps(event, sort_keys=True)
        with self._lock:
            self._fh.write(line + "\n")

    def close(self):
        with self._lock:
            self._fh.flush()
            if self._owned:
                self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_spans(path: str) -> list[dict]:
    """Parse a SpanLog JSONL file back into event dicts (skips blanks)."""
    events = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


# ---------------------------------------------------------------------------
# Layer spans
# ---------------------------------------------------------------------------

PROBE = "repro_torch.obs"          # name prefix of the thread-map probes
RING = 1 << 20                     # records a thread keeps between drains
# the module whose `_is_profiler_enabled` switches the spans on; looked up
# in sys.modules at each span, so the package imports no torch
PROFILER_MODULE = "torch.autograd.profiler"


class _NoSpan:
    """The span handed out while the recorder is off: enters, exits and
    takes fields, recording nothing. It is falsy, so a call site computes
    a field only `if sp:`."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **fields):
        return self


NO_SPAN = _NoSpan()


class SpanRecord:
    """One recorded span, its times in `time.time_ns()` (Unix ns, the
    profiler trace's clock). `end` is None while it is open."""
    __slots__ = ("name", "fields", "start", "end", "tid", "index", "parent",
                 "_thread")

    def __init__(self, name, fields, thread):
        self.name, self.fields = name, fields
        self.start = self.end = None
        self.tid, self._thread = thread.tid, thread
        self.index = self.parent = -1

    def __enter__(self):
        th = self._thread
        self.parent = th.stack[-1].index if th.stack else -1
        th.push(self)
        th.stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        stack = self._thread.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        return False

    def set(self, **fields):
        """Add fields (ints or tuples of ints)."""
        self.fields.update(fields)
        return self

    def event(self) -> dict:
        """The record as a `SpanLog` line (times in Unix ns)."""
        return {"event": "span", "span": self.name, "tid": self.tid,
                "index": self.index, "parent": self.parent,
                "start_ns": self.start, "end_ns": self.end, **self.fields}


class _Thread:
    """One thread's ring, stack of open spans and probe state. Only the
    owning thread writes `ring`'s right end, `stack`, `seq` and
    `dropped`; `drain` pops the left end and advances `reported`."""
    __slots__ = ("tid", "thread", "ring", "stack", "seq", "dropped",
                 "reported", "probe_gen")

    def __init__(self, capacity: int):
        self.tid = threading.get_native_id()
        self.thread = threading.current_thread()
        self.ring = deque(maxlen=capacity)
        self.stack: list[SpanRecord] = []
        self.seq = self.dropped = self.reported = 0
        self.probe_gen = -1

    def push(self, rec: SpanRecord):
        if len(self.ring) == self.ring.maxlen:
            self.dropped += 1
        rec.index = self.seq
        self.seq += 1
        self.ring.append(rec)


class SpanRecorder:
    """Layer spans of one process: a bounded ring per thread, switched on
    by `enable()` or by a running torch profiler."""

    def __init__(self, capacity: int = RING):
        self.capacity = int(capacity)
        self.enabled = False
        self._gen = 0
        self._lock = threading.Lock()
        self._threads: list[_Thread] = []
        self._local = threading.local()

    def span(self, name: str, **fields):
        """A context manager around one call into a layer: a `SpanRecord`
        while recording, else the shared `NO_SPAN`."""
        prof = sys.modules.get(PROFILER_MODULE)
        profiling = prof is not None and prof._is_profiler_enabled
        if not (self.enabled or profiling):
            return NO_SPAN
        th = self._thread()
        if profiling and th.probe_gen != self._gen:
            self._probe(th, prof)
        return SpanRecord(name, fields, th)

    def _thread(self) -> _Thread:
        th = getattr(self._local, "th", None)
        if th is None:
            th = self._local.th = _Thread(self.capacity)
            with self._lock:
                self._threads.append(th)
        return th

    def _probe(self, th: _Thread, prof):
        """An empty profiler range named after the thread and the probe's
        index, with `time.time_ns()` read inside it."""
        rec = SpanRecord("", {}, th)
        th.push(rec)
        rec.name = f"{PROBE}#{th.tid}#{rec.index}"
        rec.parent = th.stack[-1].index if th.stack else -1
        with prof.record_function(rec.name):
            rec.start = rec.end = time.time_ns()
        th.probe_gen = self._gen

    def enable(self):
        self.enabled = True
        self._gen += 1

    def disable(self):
        self.enabled = False
        self._gen += 1

    def drain(self) -> tuple[list[SpanRecord], int]:
        """(records, dropped): every thread's records since the last drain,
        oldest first by thread (spans still open have `end` None), and
        how many the rings dropped. Forgets threads that have ended."""
        out, dropped = [], 0
        with self._lock:
            self._gen += 1
            keep = []
            for th in self._threads:
                for _ in range(len(th.ring)):
                    out.append(th.ring.popleft())
                d = th.dropped
                dropped += d - th.reported
                th.reported = d
                if th.thread.is_alive() or th.ring:
                    keep.append(th)
            self._threads = keep
        return out, dropped


_RECORDER = SpanRecorder()             # the process-wide recorder
span = _RECORDER.span
enable = _RECORDER.enable
disable = _RECORDER.disable
drain = _RECORDER.drain
