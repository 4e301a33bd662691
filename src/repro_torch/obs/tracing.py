"""Request spans: contiguous per-stage timing for scheduler requests.

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
"""
from __future__ import annotations

import json
import threading
import time

__all__ = ["Span", "SpanLog", "read_spans"]

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
