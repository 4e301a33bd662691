"""Request-level serving scheduler: continuous batching, multi-tenant.

Counterpart of `repro.launch.scheduler`, line for line but for the device
boundary: a slot batch is handed to predict_fn as host numpy (a fleet's
engine makes it a tensor on the fleet's device and dtype), the worker
synchronises the answer's stream before it reads the device time, and
the answers come back to host numpy inside the retry guard, so a
deferred CUDA error fails the dispatch (retried, isolated, reported),
never the worker.

The v1 `FrontDoor` collected fixed-shape micro-batches behind one queue —
fine for one fleet, wrong for a service: every request waited behind the
batch barrier, and a second fleet needed a second process. This module is
the front door v2, structured like an LLM serving engine's
`add_request`/`step` loop (aphrodite/vLLM style), adapted to GP fleets
whose unit of work is a *query row* instead of a token:

  add_request(Xq, tenant=..., deadline_ms=..., priority=...) -> Future
      clients enqueue ragged (Nq_i, D) query arrays at any time and get a
      Future of (mean (Nq_i,), var (Nq_i,)) immediately.
  step()
      packs the next batch SLOT for one tenant and runs it. Slots are
      fixed-geometry (a short ladder of chunk-aligned sizes, each served
      once at warm-up), but their *contents* are continuous: whatever
      requests are pending join the next slot immediately — a request
      never waits for a full batch to assemble, and a large request
      streams across several slots. Tenants are interleaved round-robin,
      so many resident `GPFleet`s (different configs, checkpoints,
      windows) share one process and one device, each serving from its
      own engine.

Scheduling policy, per tenant:

  priority      higher-priority requests are packed first (FIFO within a
                priority level).
  deadline      a request past its deadline at packing time is either
                DROPPED (its Future raises `DeadlineExceeded`; default) or
                DE-PRIORITIZED (served only when no in-deadline work is
                pending) — `deadline_policy="drop" | "deprioritize"`.
                Work that already started streaming is always finished.
  admission     `queue_depth` bounds the *queued* (undispatched) query
                rows. Over the bound, `add_request` either BLOCKS
                (backpressure, `admission="block"`) or raises
                `SchedulerSaturated` (`admission="reject"` — what an
                open-loop load generator wants to measure).

Slot geometry: a tenant's `slots` ladder is quantized (chunk-aligned,
doubling) so a dispatch runs a right-sized batch instead of padding to
the full one — log-many geometries total, each served once at
registration (`warm=True`), none new while serving (asserted via the
engines' `jit_cache_misses` geometry counters in
tests/test_torch_scheduler.py). Backlogs round DOWN the ladder (`pick_slot`),
unless the next slot up would be >= 75% occupied — then they round up and
clear the backlog in one padded dispatch. Under load every program runs
at or near full occupancy and padding stays bounded.

Locking: `_lock` guards queues and lifecycle; packing happens under it,
the engine call does NOT (submits keep flowing while a slot computes).
`add_request`'s backpressure wait is a Condition wait — it releases the
lock, and `close()` wakes every waiter — so a blocked submitter can never
stall shutdown (the v1 `submit`-holds-lock-while-`put`-blocks bug is
structurally impossible here).

Observability (repro_torch.obs, docs/observability.md): every `TenantStats`
counter mirrors into the metrics registry as a `tenant`-labeled series
(gp_requests_total, gp_queries_total, ...), request latency rides a
bounded histogram sketch instead of a sample deque, and each request
carries a `Span` through queue -> pack -> dispatch -> device -> stitch
whose per-stage timings land in gp_request_stage_seconds and — when a
`span_log` is configured — in a JSONL event per request. All timing uses
`time.perf_counter()` (monotonic, highest resolution); disabling the
registry reduces every hook to an early-return.

`GPFleet.to_server()` returns a one-tenant scheduler; `launch.frontdoor.
FrontDoor` is the v1-compatible shim over the same machinery.
"""
from __future__ import annotations

import heapq
import os
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from ..obs import Histogram, MetricsRegistry, Span, SpanLog, default_registry
from ..obs.tracing import span

__all__ = [
    "ServingScheduler", "Tenant", "TenantStats",
    "DeadlineExceeded", "SchedulerClosed", "SchedulerSaturated",
    "SchedulerStalled", "slot_ladder", "pick_slot",
]


class SchedulerClosed(RuntimeError):
    """add_request after close() (or while close() is tearing down)."""


class SchedulerStalled(RuntimeError):
    """A dispatched slot exceeded the scheduler's stall timeout: the
    watchdog failed its in-flight Futures, quarantined the tenant, and
    failed the tenant's queued work so no client ever hangs on a wedged
    predict_fn. The tenant un-quarantines if the stuck call returns."""


class SchedulerSaturated(RuntimeError):
    """Admission control rejected the request (queue_depth exceeded,
    admission="reject")."""


class DeadlineExceeded(RuntimeError):
    """The request passed its deadline before any of it was scheduled
    (deadline_policy="drop")."""


def _wait(x) -> None:
    """Block until the device work behind answer `x` is done (a tensor on
    a CUDA device: its stream; anything else is already on the host)."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.current_stream(x.device).synchronize()


def _host(x) -> np.ndarray:
    """A host numpy copy of an answer (a tensor on any device, or an
    array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def slot_ladder(align: int, max_slot: int) -> tuple[int, ...]:
    """Quantized slot geometries: align, 2*align, 4*align, ... up to
    max_slot (always included). Log-many sizes — each is one served
    geometry — while `pick_slot`'s packing keeps every dispatch above
    `align` pending rows at >= 75% occupancy (usually 100%)."""
    align, max_slot = int(align), int(max_slot)
    if align <= 0 or max_slot <= 0:
        raise ValueError(f"slot geometry must be positive, got "
                         f"align={align}, max_slot={max_slot}")
    if max_slot <= align:
        return (max_slot,)
    sizes = []
    s = align
    while s < max_slot:
        sizes.append(s)
        s *= 2
    sizes.append(max_slot)
    return tuple(sizes)


def pick_slot(slots: tuple[int, ...], n_rows: int,
              pad_budget: float = 0.25) -> int:
    """Best slot for `n_rows` pending rows: an exact ladder fit when one
    exists; otherwise round UP to the next slot when it would still be at
    least `1 - pad_budget` occupied (clear the whole backlog now, padding
    bounded); otherwise the largest slot BELOW the backlog (dispatch it
    100% occupied, the remainder rides the next step); otherwise — fewer
    pending rows than the smallest slot — the smallest slot, padded.

    Rounding DOWN by default is what makes the ladder pay off under load:
    a 133-row backlog on a (32..256) ladder dispatches a full 128-row
    program now instead of a 256-row program carrying 123 pad rows, so
    steady-state padding stays near zero and effective capacity stays at
    the compiled programs' rows/s instead of decaying with occupancy. The
    bounded round-up handles the saturation edge: at 107 pending rows,
    strictly rounding down dispatches a 64-slot program (serving 60% of
    the backlog at the small program's worse rows/s plus a full
    per-dispatch overhead for the remainder) and the scheduler can lock
    into chasing its own queue; padding 21 rows into a 128 slot clears
    the backlog in one dispatch for a bounded 16% occupancy loss."""
    if n_rows >= slots[-1]:
        return slots[-1]
    down = up = None
    for s in slots:
        if s == n_rows:
            return s
        if s < n_rows:
            down = s
        else:
            up = s
            break
    if down is None:
        return slots[0]
    if (up - n_rows) / up <= pad_budget:
        return up
    return down


# counter field -> registry metric name (the per-tenant labeled mirror)
_STAT_COUNTERS = {
    "requests": ("gp_requests_total", "requests accepted"),
    "queries": ("gp_queries_total", "real (client) query rows served"),
    "batches": ("gp_batches_total", "slots dispatched"),
    "padded_queries": ("gp_padded_queries_total",
                       "pad rows dispatched alongside real rows"),
    "dropped": ("gp_deadline_dropped_total",
                "requests dropped past their deadline"),
    "rejected": ("gp_rejected_total", "admission-control rejections"),
    "lapsed": ("gp_lapsed_total",
               "past-deadline requests de-prioritized but served"),
    "completed": ("gp_completed_total", "requests answered"),
    "retried": ("gp_retried_total",
                "slot dispatches retried after a transient failure"),
    "isolated": ("gp_isolated_total",
                 "requests answered by a per-rider isolation re-run after "
                 "their shared slot failed"),
    "stalled": ("gp_stalled_total",
                "watchdog interventions (stalled dispatches failed)"),
}
# private always-on registry backing each TenantStats' local sketch (direct
# Histogram construction: the instance is NOT registered/exported — the
# exported copy is the shared registry's tenant-labeled histogram)
_LOCAL = MetricsRegistry(enabled=True)


class TenantStats:
    """Per-tenant serving counters + a bounded request-latency sketch.

    `queries` counts real (client) rows served, `padded_queries` the pad
    rows dispatched alongside them; `batches` counts slots. `dropped` are
    deadline drops, `rejected` admission rejections, `lapsed` past-deadline
    requests de-prioritized (but eventually served).

    Latency samples land in a fixed-bucket histogram (`repro_torch.obs`) —
    O(1) memory at any request count, percentiles within the bucket ratio
    (~19%) of exact — and every counter mirrors into the scheduler's
    metrics registry as a `tenant`-labeled series (docs/observability.md
    lists the names). The local counts here remain the authoritative read
    surface; the registry mirror is what exporters scrape.
    """

    def __init__(self, tenant: str = "default",
                 registry: MetricsRegistry | None = None):
        self.tenant = tenant
        self._registry = registry if registry is not None \
            else default_registry()
        self._lock = threading.Lock()
        self._counts = {f: 0 for f in _STAT_COUNTERS}
        self._engine_seconds = 0.0
        self._lat = Histogram("latency_seconds", "", _LOCAL)
        reg = self._registry
        self._mirror = {f: reg.counter(name, help)
                        for f, (name, help) in _STAT_COUNTERS.items()}
        self._mirror_engine = reg.counter(
            "gp_engine_seconds_total", "engine-busy seconds")
        self._mirror_lat = reg.histogram(
            "gp_request_latency_seconds", "end-to-end request latency")
        self._mirror_stage = reg.histogram(
            "gp_request_stage_seconds", "per-stage request time "
            "(queue|pack|dispatch|device|stitch)")
        self._gauge_pad = reg.gauge(
            "gp_padding_fraction", "pad rows / dispatched rows")

    # -- mutation (scheduler-internal) --------------------------------------

    def count(self, field: str, n: int = 1):
        with self._lock:
            self._counts[field] += n
        self._mirror[field].inc(n, tenant=self.tenant)

    def add_engine_seconds(self, dt: float):
        with self._lock:
            self._engine_seconds += dt
        self._mirror_engine.inc(dt, tenant=self.tenant)

    def record_latency(self, seconds: float):
        self._lat.observe(seconds)
        self._mirror_lat.observe(seconds, tenant=self.tenant)
        self.count("completed")

    def record_stages(self, stages: dict[str, float]):
        for stage, dt in stages.items():
            self._mirror_stage.observe(dt, tenant=self.tenant, stage=stage)

    def update_gauges(self):
        self._gauge_pad.set(self.padding_fraction, tenant=self.tenant)

    # -- read surface (v1-compatible) ---------------------------------------

    def _get(self, field: str) -> int:
        with self._lock:
            return self._counts[field]

    @property
    def requests(self) -> int:
        return self._get("requests")

    @property
    def queries(self) -> int:
        return self._get("queries")

    @property
    def batches(self) -> int:
        return self._get("batches")

    @property
    def padded_queries(self) -> int:
        return self._get("padded_queries")

    @property
    def dropped(self) -> int:
        return self._get("dropped")

    @property
    def rejected(self) -> int:
        return self._get("rejected")

    @property
    def lapsed(self) -> int:
        return self._get("lapsed")

    @property
    def completed(self) -> int:
        return self._get("completed")

    @property
    def retried(self) -> int:
        return self._get("retried")

    @property
    def isolated(self) -> int:
        return self._get("isolated")

    @property
    def stalled(self) -> int:
        return self._get("stalled")

    @property
    def engine_seconds(self) -> float:
        with self._lock:
            return self._engine_seconds

    @property
    def padding_fraction(self) -> float:
        with self._lock:
            total = self._counts["queries"] + self._counts["padded_queries"]
            return self._counts["padded_queries"] / total if total else 0.0

    def latency_ms(self, *quantiles: float) -> tuple[float, ...]:
        """Request-latency percentiles in ms, e.g. stats.latency_ms(50, 99)
        -> (p50, p99). NaN when nothing completed yet."""
        return tuple(self._lat.quantile(q / 100.0) * 1e3 for q in quantiles)

    def __repr__(self):
        with self._lock:
            counts = dict(self._counts)
        return f"TenantStats({self.tenant!r}, {counts})"


class _Request:
    """One in-flight request; `off` rows are already reserved into slots,
    `parts` holds the per-slot answer slices until all `n` rows return."""
    __slots__ = ("Xq", "n", "fut", "priority", "deadline", "arrival", "seq",
                 "off", "parts", "lapsed", "span")

    def __init__(self, Xq, fut, priority, deadline, arrival, seq, span=None):
        self.Xq = Xq
        self.n = Xq.shape[0]
        self.fut = fut
        self.priority = priority
        self.deadline = deadline
        self.arrival = arrival
        self.seq = seq
        self.off = 0
        self.parts: list = []
        self.lapsed = False
        self.span = span

    @property
    def sort_key(self):
        return (-self.priority, self.seq)


class Tenant:
    """One resident serving target: a predict_fn plus its slot geometry,
    queues, and policies. Created through `ServingScheduler.add_tenant` /
    `add_fleet`."""

    def __init__(self, name: str, predict_fn, slots, *, queue_depth: int,
                 admission: str, deadline_policy: str, max_wait_s: float,
                 registry: MetricsRegistry | None = None, retries: int = 2,
                 retry_backoff_ms: float = 1.0, isolate: bool = True):
        if admission not in ("block", "reject"):
            raise ValueError(f"admission must be 'block' or 'reject', "
                             f"got {admission!r}")
        if deadline_policy not in ("drop", "deprioritize"):
            raise ValueError(f"deadline_policy must be 'drop' or "
                             f"'deprioritize', got {deadline_policy!r}")
        slots = tuple(sorted(int(s) for s in slots))
        if not slots or slots[0] <= 0:
            raise ValueError(f"slots must be positive sizes, got {slots}")
        self.name = name
        self.predict_fn = predict_fn
        self.slots = slots
        self.queue_depth = int(queue_depth)
        self.admission = admission
        self.deadline_policy = deadline_policy
        self.max_wait_s = float(max_wait_s)
        self.retries = int(retries)
        self.retry_backoff_ms = float(retry_backoff_ms)
        self.isolate = bool(isolate)
        self.stats = TenantStats(name, registry=registry)
        # scheduling state (all guarded by the scheduler's _lock)
        self.heap: list = []          # (sort_key, _Request) in-deadline work
        self.lapsed: deque = deque()  # past-deadline, deprioritized FIFO
        self.carry: _Request | None = None   # partially-packed request
        self.pending_rows: int = 0    # queued (undispatched) rows
        self.oldest: float | None = None     # arrival of oldest pending
        # fault-tolerance state (also guarded by the scheduler's _lock)
        self.inflight = False         # a packed slot is inside predict_fn
        self.inflight_since: float | None = None
        self.inflight_riders: list | None = None
        self.quarantined = False      # watchdog benched this tenant

    # -- queue state helpers (call with the scheduler lock held) ------------

    def _has_pending(self) -> bool:
        return self.pending_rows > 0

    def _refresh_oldest(self):
        arrivals = [r.arrival for _, r in self.heap]
        arrivals += [r.arrival for r in self.lapsed]
        if self.carry is not None:
            arrivals.append(self.carry.arrival)
        self.oldest = min(arrivals) if arrivals else None

    def _dispatchable(self, now: float) -> bool:
        if not self._has_pending():
            return False
        if self.pending_rows >= self.slots[-1]:
            return True
        return (self.oldest is not None
                and now - self.oldest >= self.max_wait_s)

    def _wait_deadline(self) -> float | None:
        """Absolute monotonic time at which pending work must dispatch."""
        if not self._has_pending() or self.oldest is None:
            return None
        return self.oldest + self.max_wait_s


class ServingScheduler:
    """Continuous-batching, multi-tenant request scheduler (front door v2).

        sched = ServingScheduler(max_wait_ms=2.0)
        sched.add_fleet("maps", fleet_a)
        sched.add_fleet("robots", fleet_b, method="nn_rbcm")
        fut = sched.add_request(Xq, tenant="maps", deadline_ms=50.0)
        mean, var = fut.result()
        sched.close()             # or use as a context manager

    A background worker drives `step()`; construct with `autostart=False`
    to drive it manually (deterministic tests). `submit` is an alias of
    `add_request` so a one-tenant scheduler is a drop-in for the v1
    FrontDoor surface (`GPFleet.to_server()` returns exactly that).

    `registry` (default: the process-wide `repro_torch.obs.default_registry()`)
    receives the tenant-labeled counter/histogram mirror; `span_log` (a
    path or `repro_torch.obs.SpanLog`) exports one JSONL event per finished
    request with the per-stage span timings.
    """

    def __init__(self, *, max_wait_ms: float = 2.0, autostart: bool = True,
                 registry: MetricsRegistry | None = None, span_log=None,
                 stall_timeout_ms: float | None = None):
        self.max_wait_s = float(max_wait_ms) * 1e-3
        self.registry = registry if registry is not None \
            else default_registry()
        self._own_span_log = isinstance(span_log, (str, os.PathLike))
        self.span_log: SpanLog | None = (
            SpanLog(span_log) if self._own_span_log else span_log)
        self._tenants: dict[str, Tenant] = {}
        self._order: list[str] = []
        self._rr = 0                      # round-robin cursor into _order
        self._seq = 0
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)    # new work / close
        self._space = threading.Condition(self._lock)   # queue space freed
        self._closing = False
        self._draining = False
        self._worker: threading.Thread | None = None
        self._worker_gen = 0          # bumped when the watchdog respawns
        self._autostart = bool(autostart)
        if autostart:
            self._spawn_worker_locked()
        # stall watchdog: fails in-flight Futures of a dispatch that has
        # been inside predict_fn longer than the timeout (see _watchdog)
        self.stall_timeout_s = (None if stall_timeout_ms is None
                                else float(stall_timeout_ms) * 1e-3)
        self._wd_stop = threading.Event()
        self._watchdog: threading.Thread | None = None
        if self.stall_timeout_s is not None:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="gp-scheduler-watchdog",
                daemon=True)
            self._watchdog.start()

    def _spawn_worker_locked(self):
        self._worker_gen += 1
        self._worker = threading.Thread(
            target=self._worker_loop, args=(self._worker_gen,),
            name=f"gp-scheduler-{self._worker_gen}", daemon=True)
        self._worker.start()

    def _tracing(self) -> bool:
        return self.span_log is not None or self.registry.enabled

    def _emit(self, event: dict):
        if self.span_log is not None:
            self.span_log.emit(event)

    # -- tenant registration -------------------------------------------------

    def add_tenant(self, name: str, predict_fn, *, slots,
                   queue_depth: int = 1024, admission: str = "block",
                   deadline_policy: str = "drop",
                   max_wait_ms: float | None = None,
                   warm_example=None, retries: int = 2,
                   retry_backoff_ms: float = 1.0,
                   isolate: bool = True) -> Tenant:
        """Register a serving target.

        predict_fn((S, D)) -> (mean (S,), var (S,), ...) for every S in
        `slots`, on a host numpy batch (answers may be tensors on any
        device).
        `warm_example` (a (D,) row, or (n, D) array whose first row is
        used) serves every slot geometry NOW so serving meets no new one;
        pass None to let the first dispatches meet them lazily.

        Failure policy: a slot whose predict_fn raises is retried
        `retries` times with exponential backoff (retry_backoff_ms * 2^k);
        if it still fails and `isolate=True`, each rider is re-run ALONE in
        the smallest fitting slot so one poisoned request cannot fail its
        batch-mates — only riders that fail solo get the exception.
        """
        tenant = Tenant(name, predict_fn, slots, queue_depth=queue_depth,
                        admission=admission, deadline_policy=deadline_policy,
                        max_wait_s=(self.max_wait_s if max_wait_ms is None
                                    else float(max_wait_ms) * 1e-3),
                        registry=self.registry, retries=retries,
                        retry_backoff_ms=retry_backoff_ms, isolate=isolate)
        with self._lock:
            if self._closing:
                raise SchedulerClosed("scheduler is closed")
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
            self._tenants[name] = tenant
            self._order.append(name)
        if warm_example is not None:
            self.warm(name, warm_example)
        return tenant

    def add_fleet(self, name: str, fleet, *, method: str | None = None,
                  max_slot: int | None = None, continuous: bool = True,
                  queue_depth: int = 1024, admission: str = "block",
                  deadline_policy: str = "drop",
                  max_wait_ms: float | None = None,
                  warm: bool = True, retries: int = 2,
                  retry_backoff_ms: float = 1.0,
                  isolate: bool = True, fault_plan=None) -> Tenant:
        """Register a fitted `GPFleet` as a tenant.

        Slot geometry derives from the fleet: align = engine chunk,
        ceiling = the method registry's `max_slot` capability (capped by
        `max_slot` here). `continuous=True` serves the quantized ladder
        (right-sized slots, the v2 behavior); `continuous=False` pins the
        single fixed geometry the v1 FrontDoor used.

        `fault_plan` (chaos.FaultPlan) runs the tenant under chaos:
        consensus faults ride `GPFleet.predict(fault_plan=...,
        allow_degraded=True)` — warm-up serves the degraded geometries, so
        the zero-new-geometry contract still holds — while the plan's
        serving faults (stragglers, injected failures) wrap the predict_fn
        on the dispatch path AFTER warm-up (`chaos.wrap_predict_fn`).
        """
        align, reg_max = fleet.slot_geometry(method)
        hi = reg_max if max_slot is None else int(max_slot)
        slots = slot_ladder(align, hi) if continuous else (hi,)
        if fault_plan is None:
            predict_fn = (lambda Xs: fleet.predict(Xs, method=method))
        else:
            predict_fn = (lambda Xs: fleet.predict(
                Xs, method=method, fault_plan=fault_plan,
                allow_degraded=True))
        example = None
        if warm:
            example = np.zeros((1, int(fleet.config.input_dim)))
        tenant = self.add_tenant(name, predict_fn, slots=slots,
                                 queue_depth=queue_depth,
                                 admission=admission,
                                 deadline_policy=deadline_policy,
                                 max_wait_ms=max_wait_ms,
                                 warm_example=example, retries=retries,
                                 retry_backoff_ms=retry_backoff_ms,
                                 isolate=isolate)
        if fault_plan is not None and not fault_plan.empty:
            # serving faults start AFTER warm-up so registration cannot be
            # failed or slowed by the plan's own injections
            from ..chaos import wrap_predict_fn
            tenant.predict_fn = wrap_predict_fn(tenant.predict_fn,
                                                fault_plan)
        # pull-style gauge: the engine's geometry count (the reference's
        # trace count), sampled at collect time — "new geometries after
        # warm-up" is this minus its post-warm value
        self.registry.gauge(
            "gp_jit_cache_misses",
            "engine trace count (distinct compiled programs)").set_fn(
            lambda: float(fleet.jit_cache_misses), tenant=name)
        # pull-style gauge: queued (undispatched) rows per tenant, sampled
        # at collect time — the backlog signal autoscalers/dashboards watch
        self.registry.gauge(
            "gp_tenant_queued_rows",
            "queued (undispatched) request rows per tenant").set_fn(
            lambda: float(tenant.pending_rows), tenant=name)
        return tenant

    def warm(self, name: str, example) -> None:
        """Serve every slot geometry of tenant `name` once on `example`
        (a (D,) row or an (n, D) array) so serving meets no new geometry
        (the reference compiles them here)."""
        t = self._get(name)
        row = np.asarray(example)
        row = row[0] if row.ndim == 2 else row
        for s in t.slots:
            batch = np.repeat(row[None], s, axis=0)
            _wait(t.predict_fn(batch)[0])

    def _get(self, name: str | None) -> Tenant:
        if name is None:
            if len(self._tenants) != 1:
                raise ValueError(
                    f"tenant= is required when {len(self._tenants)} tenants "
                    f"are registered ({sorted(self._tenants)})")
            return next(iter(self._tenants.values()))
        t = self._tenants.get(name)
        if t is None:
            raise KeyError(f"unknown tenant {name!r}; registered: "
                           f"{sorted(self._tenants)}")
        return t

    @property
    def tenants(self) -> tuple[str, ...]:
        return tuple(self._order)

    @property
    def tenant_stats(self) -> dict[str, TenantStats]:
        return {n: t.stats for n, t in self._tenants.items()}

    @property
    def stats(self) -> TenantStats:
        """The single tenant's stats (v1 FrontDoor compat). For multi-
        tenant schedulers use `tenant_stats[name]`."""
        if len(self._tenants) != 1:
            raise ValueError("stats is single-tenant sugar; use "
                             "tenant_stats for multi-tenant schedulers")
        return next(iter(self._tenants.values())).stats

    # -- client side ---------------------------------------------------------

    def add_request(self, Xq, *, tenant: str | None = None,
                    priority: int = 0,
                    deadline_ms: float | None = None) -> Future:
        """Enqueue one (Nq, D) request -> Future of (mean (Nq,), var (Nq,)).

        Raises `SchedulerClosed` after close(); over `queue_depth` either
        blocks (admission="block") or raises `SchedulerSaturated`.
        Higher `priority` packs first; `deadline_ms` is relative to now
        (see the tenant's deadline_policy for what expiry means).
        """
        Xq = np.asarray(Xq)
        if Xq.ndim != 2:
            raise ValueError(f"request must be (Nq, D), got {Xq.shape}")
        if Xq.shape[0] == 0:
            raise ValueError("request must contain at least one query row")
        t = self._get(tenant)
        now = time.perf_counter()
        deadline = None if deadline_ms is None else now + deadline_ms * 1e-3
        fut: Future = Future()
        span = Span("request", t=now, tenant=t.name,
                    priority=int(priority)) if self._tracing() else None
        with self._lock:
            if self._closing:
                raise SchedulerClosed("scheduler is closed")
            if t.quarantined:
                raise SchedulerStalled(
                    f"tenant {t.name!r} is quarantined: its predict_fn "
                    f"stalled past the watchdog timeout and has not "
                    f"returned")
            while t.pending_rows + Xq.shape[0] > t.queue_depth:
                if t.admission == "reject":
                    t.stats.count("rejected")
                    raise SchedulerSaturated(
                        f"tenant {t.name!r} queue is full "
                        f"({t.pending_rows} rows >= depth {t.queue_depth})")
                # backpressure: wait WITHOUT the lock (Condition.wait
                # releases it) so close() and the packer both get through
                self._space.wait()
                if self._closing:
                    raise SchedulerClosed("scheduler closed while waiting "
                                          "for queue space")
            self._seq += 1
            req = _Request(Xq, fut, int(priority), deadline, now, self._seq,
                           span=span)
            if span is not None:
                span.labels["seq"] = req.seq
            heapq.heappush(t.heap, (req.sort_key, req))
            t.pending_rows += req.n
            if t.oldest is None or now < t.oldest:
                t.oldest = now
            self._work.notify_all()
        t.stats.count("requests")
        return fut

    # v1 FrontDoor-compatible alias (GPFleet.to_server returns a scheduler)
    submit = add_request

    # -- scheduling core -----------------------------------------------------

    def _next_tenant_locked(self, now: float, force: bool) -> Tenant | None:
        """Round-robin over tenants with dispatchable work (any pending
        work when force/draining)."""
        n = len(self._order)
        for i in range(n):
            name = self._order[(self._rr + i) % n]
            t = self._tenants[name]
            if t.inflight or t.quarantined:
                # inflight: a (possibly zombie) thread is already inside
                # this tenant's predict_fn; quarantined: the watchdog
                # benched it until that call returns
                continue
            ok = t._has_pending() if (force or self._draining) \
                else t._dispatchable(now)
            if ok:
                self._rr = (self._rr + i + 1) % n
                return t
        return None

    def _pop_locked(self, t: Tenant, now: float, dropped: list):
        """Next request to pack, honoring carry > priority > lapsed order
        and the deadline policy. Returns None when nothing is packable."""
        if t.carry is not None:
            req, t.carry = t.carry, None
            return req
        while t.heap:
            _, req = heapq.heappop(t.heap)
            if (req.deadline is not None and now > req.deadline
                    and req.off == 0):
                if t.deadline_policy == "drop":
                    t.pending_rows -= req.n
                    dropped.append(req)
                    continue
                if not req.lapsed:
                    req.lapsed = True
                    t.stats.count("lapsed")
                t.lapsed.append(req)
                continue
            return req
        if t.lapsed:
            return t.lapsed.popleft()
        return None

    def _pack_locked(self, t: Tenant, now: float, dropped: list):
        """Reserve up to one slot of rows from tenant `t`'s queues.
        Returns (riders, slot) — riders are (request, start_row, n_rows)
        triples — or None if every pending request was dropped."""
        slot = pick_slot(t.slots, t.pending_rows)
        riders = []
        rows = 0
        while rows < slot:
            req = self._pop_locked(t, now, dropped)
            if req is None:
                break
            take = min(req.n - req.off, slot - rows)
            riders.append((req, req.off, take))
            req.off += take
            rows += take
            t.pending_rows -= take
            if req.off < req.n:       # slot filled mid-request: carry over
                t.carry = req
                break
        t._refresh_oldest()
        if riders or dropped:      # either way rows left the queue
            self._space.notify_all()
        if not riders:
            return None
        return riders, slot

    def step(self, *, force: bool = False) -> bool:
        """Pack and serve ONE slot for the next tenant in round-robin
        order. Returns True if a slot was dispatched. `force` dispatches
        partial slots immediately (drain / manual stepping)."""
        with span("frontdoor.slot") as sp:
            now = time.perf_counter()
            dropped: list[_Request] = []
            with span("frontdoor.pack"), self._lock:
                t = self._next_tenant_locked(now, force)
                plan = None if t is None \
                    else self._pack_locked(t, now, dropped)
                if plan is not None:
                    # mark in-flight UNDER the pack lock so the watchdog
                    # sees the dispatch the moment it can exist
                    t.inflight = True
                    t.inflight_since = time.perf_counter()
                    t.inflight_riders = list(plan[0])
            # futures resolve OUTSIDE the lock: done-callbacks may re-enter
            # (submit a follow-up request) without deadlocking
            for req in dropped:
                t.stats.count("dropped")
                if req.span is not None:
                    req.span.advance("queue")
                    self._emit(req.span.event("deadline_dropped",
                                              rows=req.n))
                if not req.fut.cancelled():
                    req.fut.set_exception(DeadlineExceeded(
                        f"request missed its deadline by "
                        f"{(now - req.deadline) * 1e3:.1f} ms before "
                        f"scheduling"))
            if plan is None:
                return False
            if sp:
                sp.set(seqs=tuple(req.seq for req, _, _ in plan[0]))
            self._execute(t, *plan, t_pack0=now)
            return True

    def _predict_slot(self, t: Tenant, batch, rows: int, retries: int):
        """Run one slot batch through predict_fn with retry-on-failure
        (exponential backoff). Returns host arrays (mean, var, t_disp,
        t_dev); raises the LAST exception once retries are exhausted.
        device->host transfer stays inside the guard: deferred runtime
        errors surface here, failing the dispatch and not the worker."""
        attempt = 0
        while True:
            try:
                out = t.predict_fn(batch)
                mean, var = out[0], out[1]
                t_disp = time.perf_counter()   # async dispatch returned
                with span("frontdoor.sync"):
                    _wait(mean)
                t_dev = time.perf_counter()
                with span("frontdoor.copy"):
                    return (_host(mean)[:rows], _host(var)[:rows], t_disp,
                            t_dev)
            except Exception:
                if attempt >= retries:
                    raise
                t.stats.count("retried")
                time.sleep(t.retry_backoff_ms * (2.0 ** attempt) * 1e-3)
                attempt += 1

    def _fail_riders(self, t: Tenant, riders, exc):
        for req, _, _ in riders:
            if req.span is not None:
                req.span.advance("stitch")
                self._emit(req.span.event("error", rows=req.n))
            if not req.fut.done():     # done(): watchdog may have beaten us
                req.fut.set_exception(exc)

    def _deliver(self, t: Tenant, riders, mean, var, slot: int, dt: float):
        """Fan a served slot's answers back out to its riders and account
        the dispatch (called WITHOUT the lock)."""
        rows = sum(k for _, _, k in riders)
        off = 0
        done = time.perf_counter()
        for req, _, k in riders:
            req.parts.append((mean[off:off + k], var[off:off + k]))
            off += k
            if sum(p[0].shape[0] for p in req.parts) == req.n:
                m = np.concatenate([p[0] for p in req.parts])
                v = np.concatenate([p[1] for p in req.parts])
                if req.span is not None:
                    req.span.advance("stitch")
                    t.stats.record_latency(req.span.elapsed)
                    t.stats.record_stages(req.span.stages)
                    self._emit(req.span.event(
                        "ok", rows=req.n, slots=len(req.parts)))
                else:
                    t.stats.record_latency(done - req.arrival)
                if not req.fut.done():
                    req.fut.set_result((m, v))
            elif req.span is not None:
                req.span.advance("stitch")     # next slot waits in "queue"
        t.stats.count("queries", rows)
        t.stats.count("padded_queries", slot - rows)
        t.stats.count("batches")
        t.stats.add_engine_seconds(dt)
        t.stats.update_gauges()

    def _isolate_riders(self, t: Tenant, riders, exc):
        """Per-rider failure isolation: the shared slot failed after
        retries, so re-run each rider ALONE (smallest fitting slot, single
        attempt). Healthy riders get answers; only the poisoned one(s)
        get the exception."""
        for rider in riders:
            req, a, k = rider
            sub = req.Xq[a:a + k]
            slot = next((s for s in t.slots if s >= k), t.slots[-1])
            batch = sub if k == slot else np.concatenate(
                [sub, np.repeat(sub[-1:], slot - k, axis=0)])
            t0 = time.perf_counter()
            try:
                mean, var, _, t_dev = self._predict_slot(t, batch, k, 0)
            except Exception as sub_exc:
                self._fail_riders(t, [rider], sub_exc)
            else:
                t.stats.count("isolated")
                self._deliver(t, [rider], mean, var, slot, t_dev - t0)

    def _execute(self, t: Tenant, riders, slot: int, *,
                 t_pack0: float | None = None):
        """Run one packed slot through the tenant's predict_fn and fan the
        answers back out (called WITHOUT the lock)."""
        if t_pack0 is None:
            t_pack0 = time.perf_counter()
        try:
            with span("frontdoor.pack"):
                parts = [req.Xq[a:a + k] for req, a, k in riders]
                rows = sum(k for _, _, k in riders)
                batch = np.concatenate(parts, axis=0)
                if rows < slot:
                    # edge-replicate: pad rows are a served workload,
                    # never X=0
                    batch = np.concatenate(
                        [batch, np.repeat(batch[-1:], slot - rows, axis=0)])
            t0 = time.perf_counter()
            for req, _, _ in riders:
                if req.span is not None:
                    # a multi-slot request re-enters "queue" after each
                    # slot's stitch, so stages stay contiguous across slots
                    req.span.advance("queue", t_pack0)
                    req.span.advance("pack", t0)
            try:
                mean, var, t_disp, t_dev = self._predict_slot(
                    t, batch, rows, t.retries)
            except Exception as exc:
                if t.isolate and len(riders) > 1:
                    self._isolate_riders(t, riders, exc)
                else:
                    self._fail_riders(t, riders, exc)
                return
            for req, _, _ in riders:
                if req.span is not None:
                    req.span.advance("dispatch", t_disp)
                    req.span.advance("device", t_dev)
            with span("frontdoor.deliver"):
                self._deliver(t, riders, mean, var, slot, t_dev - t0)
        finally:
            with self._lock:
                t.inflight = False
                t.inflight_since = None
                t.inflight_riders = None
                if t.quarantined:
                    # the stalled call came back (its riders were already
                    # failed by the watchdog): the tenant can serve again
                    t.quarantined = False
                self._work.notify_all()

    # -- worker / lifecycle --------------------------------------------------

    def _worker_loop(self, gen: int | None = None):
        while True:
            with self._lock:
                if self._closing:
                    return
                if gen is not None and gen != self._worker_gen:
                    return     # superseded by a watchdog-spawned worker
                now = time.perf_counter()
                timeout = None
                ready = False
                for t in self._tenants.values():
                    if t.inflight or t.quarantined:
                        continue
                    if t._dispatchable(now):
                        ready = True
                        break
                    wd = t._wait_deadline()
                    if wd is not None:
                        remaining = max(1e-4, wd - now)
                        timeout = remaining if timeout is None \
                            else min(timeout, remaining)
                if not ready:
                    # pending rows at entry: 0 is no work, more is the
                    # batching hold
                    with span("frontdoor.wait") as sp:
                        if sp:
                            sp.set(pending=sum(t.pending_rows for t in
                                               self._tenants.values()))
                        self._work.wait(timeout=timeout)
                    if self._closing:
                        return
                    if gen is not None and gen != self._worker_gen:
                        return
            self.step()

    def _watchdog_loop(self):
        """Fail the Futures of any dispatch stuck inside predict_fn past
        `stall_timeout_s`, quarantine the tenant (until the stuck call
        returns), fail its queued work, and respawn the worker so OTHER
        tenants keep serving. The stuck thread itself cannot be killed —
        when it eventually returns, `_execute`'s `fut.done()` guards make
        its late answers no-ops."""
        poll = max(self.stall_timeout_s / 4.0, 1e-3)
        while not self._wd_stop.wait(poll):
            now = time.perf_counter()
            stalled = []
            with self._lock:
                if self._closing:
                    return
                for t in self._tenants.values():
                    if not (t.inflight and not t.quarantined
                            and t.inflight_since is not None):
                        continue
                    age = now - t.inflight_since
                    if age <= self.stall_timeout_s:
                        continue
                    t.quarantined = True
                    riders = list(t.inflight_riders or [])
                    queued = []
                    if t.carry is not None:
                        queued.append(t.carry)
                        t.carry = None
                    queued += [r for _, r in t.heap]
                    queued += list(t.lapsed)
                    t.heap.clear()
                    t.lapsed.clear()
                    t.pending_rows = 0
                    t.oldest = None
                    stalled.append((t, riders, queued, age))
                if stalled:
                    self._space.notify_all()
                    respawn = (self._worker is not None
                               and not self._closing)
                    if respawn:
                        self._spawn_worker_locked()
            for t, riders, queued, age in stalled:
                t.stats.count("stalled")
                exc = SchedulerStalled(
                    f"tenant {t.name!r} dispatch stalled for "
                    f"{age * 1e3:.0f} ms (> stall_timeout "
                    f"{self.stall_timeout_s * 1e3:.0f} ms); in-flight and "
                    f"queued requests failed, tenant quarantined")
                self._fail_riders(t, riders, exc)
                for req in queued:
                    if req.span is not None:
                        req.span.advance("queue")
                        self._emit(req.span.event("stalled", rows=req.n))
                    if not req.fut.done():
                        req.fut.set_exception(exc)

    def pending(self) -> int:
        """Total undispatched query rows across tenants."""
        with self._lock:
            return sum(t.pending_rows for t in self._tenants.values())

    def _sweep_leftovers_locked(self) -> list:
        """Remove and return every queued request (call with _lock held)."""
        leftovers = []
        for t in self._tenants.values():
            if t.carry is not None:
                leftovers.append(t.carry)
                t.carry = None
            leftovers += [r for _, r in t.heap]
            leftovers += list(t.lapsed)
            t.heap.clear()
            t.lapsed.clear()
            t.pending_rows = 0
            t.oldest = None
        return leftovers

    def close(self, *, drain: bool = True, timeout: float | None = 30.0):
        """Stop accepting requests — BOUNDED: returns within ~`timeout`
        seconds even with a wedged predict_fn or a quarantined tenant.

        drain=True (default) serves everything pending first; whatever is
        still queued at the deadline (stuck tenants, timeout hit) is
        failed with `SchedulerClosed` — no Future is ever left hanging.
        drain=False cancels every queued Future immediately.
        `timeout=None` restores the unbounded v1 wait."""
        with self._lock:
            if self._closing:
                return
            self._closing = True
            self._draining = drain
            self._work.notify_all()
            self._space.notify_all()
        deadline = None if timeout is None \
            else time.perf_counter() + float(timeout)
        self._wd_stop.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=None if deadline is None
                                else max(0.0, deadline - time.perf_counter()))
        if self._worker is not None:
            self._worker.join(timeout=None if deadline is None
                              else max(0.0, deadline - time.perf_counter()))
        if drain:
            while deadline is None or time.perf_counter() < deadline:
                if not self.step(force=True):
                    break
            with self._lock:
                leftovers = self._sweep_leftovers_locked()
                # anything still in-flight here belongs to a thread that
                # did not come back before the deadline: fail its riders
                # too (the fut.done() guards turn a late answer into a
                # no-op) so close() never strands a Future
                for t in self._tenants.values():
                    if t.inflight and t.inflight_riders:
                        leftovers += [req for req, _, _ in
                                      t.inflight_riders]
            for req in leftovers:
                if not req.fut.done():
                    req.fut.set_exception(SchedulerClosed(
                        "scheduler close(drain=True) could not serve this "
                        "request before the close timeout (stalled or "
                        "quarantined tenant)"))
        else:
            with self._lock:
                leftovers = self._sweep_leftovers_locked()
            for req in leftovers:
                # a partially-served request cannot be cancelled (its
                # Future may already have riders waiting on streamed rows
                # that will never come) — fail it explicitly instead
                if req.off > 0:
                    if not req.fut.done():
                        req.fut.set_exception(SchedulerClosed(
                            "scheduler closed mid-request (drain=False)"))
                else:
                    req.fut.cancel()
        if self._own_span_log and self.span_log is not None:
            self.span_log.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
