"""Thread-safe metrics registry: counters, gauges, histograms.

The repo's telemetry used to be ad-hoc attributes scattered per subsystem
(`TenantStats` counters inside the scheduler, `_trace_count` hand-threaded
through both engines, benchmark timers re-implemented per script). This
module is the one dependency-free home for all of it:

  Counter    monotone totals, e.g. gp_requests_total{tenant="maps"}.
  Gauge      point-in-time values; `set_fn` registers a callable sampled
             at collection time (how engine recompile counts are exported
             without polling threads).
  Histogram  fixed geometric buckets + count/sum/min/max per series. The
             bucket ratio (default 2**0.25 ~ 1.19) bounds the relative
             error of interpolated quantiles, and memory is O(buckets)
             per series — this replaces `TenantStats`' unbounded
             200k-sample latency deque.

Every metric holds LABELED series: `c.inc(tenant="maps", method="rbcm")`
creates/updates the series keyed by that label set. All mutation is
guarded by a per-metric lock; reads take the same lock and copy, so
snapshots are consistent under concurrent scheduler/worker writes
(tests/test_obs.py hammers this with racing threads).

Disabled registries make every write a cheap early-return — serving with
metrics off costs one attribute read per call site (the zero-overhead
guard in tests/test_obs.py; tests/test_torch_obs.py holds this copy to
the reference).

See docs/observability.md for the metric catalog and exporter formats.
"""
from __future__ import annotations

import bisect
import math
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "default_latency_buckets",
]


def default_latency_buckets(lo: float = 1e-6, hi: float = 60.0,
                            ratio: float = 2.0 ** 0.25) -> tuple[float, ...]:
    """Geometric bucket upper bounds spanning [lo, hi] seconds.

    The ratio between adjacent bounds caps the relative error of
    `Histogram.quantile` at ratio - 1 (~19% at the default) while keeping
    the ladder ~100 buckets long — constant memory at any sample count.
    """
    bounds = []
    b = lo
    while b < hi:
        bounds.append(b)
        b *= ratio
    bounds.append(hi)
    return tuple(bounds)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class _Metric:
    """Base: named metric holding labeled series behind one lock."""
    kind = "untyped"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry"):
        self.name = name
        self.help = help
        self._registry = registry
        self._lock = threading.Lock()
        self._series: dict = {}

    @property
    def enabled(self) -> bool:
        return self._registry.enabled

    def labelsets(self) -> list[dict]:
        with self._lock:
            return [dict(k) for k in self._series]


class Counter(_Metric):
    """Monotonically increasing total per label set."""
    kind = "counter"

    def inc(self, value: float = 1.0, **labels):
        if not self._registry.enabled:
            return
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {value})")
        k = _label_key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))

    def collect(self) -> list[tuple[dict, float]]:
        with self._lock:
            return [(dict(k), float(v)) for k, v in self._series.items()]


class Gauge(_Metric):
    """Point-in-time value per label set; `set_fn` samples a callable at
    collection time (pull-style gauges over live objects)."""
    kind = "gauge"

    def set(self, value: float, **labels):
        if not self._registry.enabled:
            return
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def set_fn(self, fn, **labels):
        """Register `fn() -> float` to be evaluated on every collect —
        registered even when the registry is disabled (registration is a
        wiring step, not a hot-path write)."""
        with self._lock:
            self._series[_label_key(labels)] = fn

    def value(self, **labels) -> float:
        with self._lock:
            v = self._series.get(_label_key(labels), float("nan"))
        return float(v()) if callable(v) else float(v)

    def collect(self) -> list[tuple[dict, float]]:
        with self._lock:
            items = list(self._series.items())
        return [(dict(k), float(v() if callable(v) else v))
                for k, v in items]


class _HistSeries:
    __slots__ = ("counts", "overflow", "count", "sum", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.overflow = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf


class Histogram(_Metric):
    """Fixed-bucket distribution sketch per label set.

    `observe(v)` lands v in the first bucket with bound >= v (overflow
    past the last bound); `quantile(q)` interpolates linearly inside the
    selected bucket, with the tracked exact min/max tightening the edge
    buckets. Error is bounded by the bucket ratio, independent of sample
    count — unlike a sample reservoir there is nothing to evict.
    """
    kind = "histogram"

    def __init__(self, name, help, registry, buckets=None):
        super().__init__(name, help, registry)
        self.buckets = tuple(float(b) for b in (
            buckets if buckets is not None else default_latency_buckets()))
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"histogram {name}: bucket bounds must be "
                             f"strictly increasing")

    def observe(self, value: float, **labels):
        if not self._registry.enabled:
            return
        value = float(value)
        i = bisect.bisect_left(self.buckets, value)
        k = _label_key(labels)
        with self._lock:
            s = self._series.get(k)
            if s is None:
                s = self._series[k] = _HistSeries(len(self.buckets))
            if i < len(self.buckets):
                s.counts[i] += 1
            else:
                s.overflow += 1
            s.count += 1
            s.sum += value
            s.min = min(s.min, value)
            s.max = max(s.max, value)

    def _get(self, labels) -> _HistSeries | None:
        return self._series.get(_label_key(labels))

    def count(self, **labels) -> int:
        with self._lock:
            s = self._get(labels)
            return 0 if s is None else s.count

    def sum(self, **labels) -> float:
        with self._lock:
            s = self._get(labels)
            return 0.0 if s is None else s.sum

    def quantile(self, q: float, **labels) -> float:
        """q in [0, 1]. NaN on an empty series. Relative error is bounded
        by the bucket ratio (bucket-linear interpolation)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile wants q in [0, 1], got {q}")
        with self._lock:
            s = self._get(labels)
            if s is None or s.count == 0:
                return float("nan")
            counts = list(s.counts) + [s.overflow]
            total, lo_exact, hi_exact = s.count, s.min, s.max
        target = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.buckets[i - 1] if i > 0 else lo_exact
                hi = self.buckets[i] if i < len(self.buckets) else hi_exact
                lo = max(lo, lo_exact)
                hi = min(hi, hi_exact)
                if hi <= lo:
                    return float(lo)
                frac = (target - cum) / c
                return float(lo + frac * (hi - lo))
            cum += c
        return float(hi_exact)

    def quantiles(self, *qs: float, **labels) -> tuple[float, ...]:
        return tuple(self.quantile(q, **labels) for q in qs)

    def collect(self) -> list[tuple[dict, dict]]:
        """[(labels, {"count", "sum", "min", "max", "counts", "overflow"})]
        — counts aligned with `self.buckets`."""
        with self._lock:
            return [(dict(k),
                     {"count": s.count, "sum": s.sum,
                      "min": (None if s.count == 0 else s.min),
                      "max": (None if s.count == 0 else s.max),
                      "counts": list(s.counts), "overflow": s.overflow})
                    for k, s in self._series.items()]


class MetricsRegistry:
    """Get-or-create home for named metrics.

        reg = MetricsRegistry()
        reg.counter("gp_requests_total", "requests").inc(tenant="maps")
        reg.histogram("gp_request_latency_seconds").observe(0.004, tenant="maps")
        snap = reg.snapshot()          # JSON-able dict of every series

    `enabled=False` (or `reg.disable()`) turns every write into an
    early-return; reads and `snapshot()` keep working on whatever was
    recorded. The process-wide instance is `default_registry()`; tests
    and embedded schedulers pass their own for isolation.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    def _get_or_create(self, cls, name, help, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, self, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=None) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def metrics(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def reset(self):
        """Drop every metric (tests; NOT thread-safe vs concurrent writers
        holding metric references)."""
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> dict:
        """JSON-able dict of every series; histograms summarized as
        count/sum/min/max plus interpolated p50/p90/p99."""
        out: dict = {}
        for m in self.metrics():
            series = []
            if m.kind == "histogram":
                for labels, s in m.collect():
                    p50, p90, p99 = m.quantiles(0.5, 0.9, 0.99, **labels)
                    series.append({
                        "labels": labels, "count": s["count"],
                        "sum": s["sum"], "min": s["min"], "max": s["max"],
                        "p50": _nan_none(p50), "p90": _nan_none(p90),
                        "p99": _nan_none(p99)})
            else:
                series = [{"labels": labels, "value": v}
                          for labels, v in m.collect()]
            out[m.name] = {"kind": m.kind, "help": m.help, "series": series}
        return out


def _nan_none(v: float):
    return None if v != v else v


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem writes to by default."""
    return _DEFAULT
