"""repro_torch.obs — the unified, dependency-free observability subsystem.

A copy of the reference's framework-free `repro.obs` (the port imports
nothing of the JAX package): the same metric names, label sets, span
stages and text formats, so dashboards and parsers read either package.
One layer for the telemetry every other subsystem feeds:

  metrics.py         thread-safe registry: counters, gauges, histograms
                     with geometric-bucket latency sketches (replaces the
                     scheduler's unbounded latency deque); labeled series
                     (tenant, method, slot, shard); `default_registry()`.
  tracing.py         per-request `Span`s through the scheduler pipeline
                     (queue -> pack -> dispatch -> device -> stitch), the
                     `SpanLog` JSONL sink, and the port's layer spans
                     (`span`, `SpanRecorder`: front door, engine,
                     consensus, trainer, streaming windows), recorded
                     while switched on or while a torch profiler runs.
  training_trace.py  `TraceRecorder`, the host-side tap for the ADMM
                     loops' device-side diagnostics (per-iteration NLL,
                     primal/dual residuals, theta trajectories) and the
                     engines' DAC/JOR per-round residual capture.
  export.py          Prometheus text dump + parser, and the
                     `/metrics` + `/statusz` HTTP endpoint behind
                     `serve_gp --metrics-port`.

The catalog of metric names and span stages is docs/observability.md.
"""
from .export import (MetricsServer, parse_prometheus_text, prometheus_text,
                     start_metrics_server)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_latency_buckets, default_registry)
from .tracing import Span, SpanLog, SpanRecorder, read_spans, span
from .training_trace import TraceRecorder

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_latency_buckets", "default_registry",
    "Span", "SpanLog", "read_spans", "SpanRecorder", "span",
    "TraceRecorder",
    "prometheus_text", "parse_prometheus_text",
    "MetricsServer", "start_metrics_server",
]
