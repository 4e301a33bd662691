"""v1 front-door compat shim over the request-level scheduler.

Counterpart of `repro.launch.frontdoor`. The original `FrontDoor` was a
single queue feeding fixed-shape micro-batches to one `predict_fn`. That
machinery now lives in `launch.scheduler.ServingScheduler` — continuous
slot packing, multi-tenant round-robin, priorities, deadlines, admission
control. This module keeps the v1 surface (`FrontDoor(predict_fn, batch)`, `submit`,
`close`, `stats`, context manager) as a one-tenant scheduler pinned to a
single fixed slot geometry, so existing callers and tests see byte-for-
byte the old behavior:

  * every dispatch runs the one `(batch, D)` geometry, padding the tail
    by edge-replication;
  * `submit` blocks for backpressure at `queue_depth` queued query rows
    and raises `RuntimeError` (`SchedulerClosed`) after `close()`;
  * `stats` is the tenant's `TenantStats`, a superset of the old
    `FrontDoorStats` (same fields + drop/reject/latency counters).

The v1 bug where `submit()` held the lifecycle lock across a blocking
queue `put()` — letting a backpressured submitter stall `close()` — is
gone structurally: the scheduler's admission wait is a Condition wait
that releases the lock, and `close()` wakes every waiter.

New code should use `ServingScheduler` (or `GPFleet.to_server()`, which
returns one) directly; this shim exists so v1 call sites keep working.
"""
from __future__ import annotations

from concurrent.futures import Future

from .scheduler import ServingScheduler, TenantStats

# v1 importers expect the stats type under this name
FrontDoorStats = TenantStats

__all__ = ["FrontDoor", "FrontDoorStats"]


class FrontDoor:
    """Micro-batching request front door over a `predict_fn` (v1 API).

    predict_fn(Xs (batch, D)) -> (mean (batch,), var (batch,), info); bind
    the method name with functools.partial, e.g.
    `FrontDoor(partial(eng.predict, "rbcm"), batch=256)`.

    Equivalent to a one-tenant `ServingScheduler` with the single slot
    geometry `(batch,)`; `queue_depth` bounds queued query ROWS (v1
    counted whole requests — rows is the resource the engine actually
    spends, and it is what the scheduler's admission control meters).
    """

    def __init__(self, predict_fn, batch: int, *, max_wait_ms: float = 2.0,
                 queue_depth: int = 1024):
        self.predict_fn = predict_fn
        self.batch = int(batch)
        self._sched = ServingScheduler(max_wait_ms=max_wait_ms)
        self._tenant = self._sched.add_tenant(
            "default", predict_fn, slots=(self.batch,),
            queue_depth=queue_depth, admission="block")

    @property
    def stats(self) -> TenantStats:
        return self._tenant.stats

    def submit(self, Xq) -> Future:
        """Enqueue one request (Nq, D) -> Future of (mean (Nq,), var (Nq,)).

        Raises RuntimeError after close(). Blocks (backpressure) when
        queue_depth query rows are already waiting.
        """
        return self._sched.add_request(Xq)

    def close(self, *, drain: bool = True):
        """Stop accepting requests; by default serve everything pending."""
        self._sched.close(drain=drain)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
