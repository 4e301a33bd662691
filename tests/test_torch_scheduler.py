"""The port's front door (repro_torch.launch.scheduler, frontdoor and
serve_gp's scheduler modes), held to the reference's scheduler cases.

The reference's cases (tests/test_scheduler.py) run here against the
port's ServingScheduler, most of them with fake predict_fns, and keep
their names:

  * two resident GPFleet tenants served round-robin from ONE scheduler,
    with no new geometry after registration warm-up — asserted via the
    engines' jit_cache_misses geometry counters;
  * continuous batching semantics: ragged requests stream across
    fixed-geometry slots and come back stitched in order, a large request
    spans several slots, answers match the direct engine call;
  * scheduling policy: priority ordering, deadline drop vs deprioritize,
    admission block (backpressure) vs reject (SchedulerSaturated);
  * lifecycle: close(drain=False) cancels riders, a submitter blocked on
    backpressure is woken (not deadlocked) by close() — the v1
    submit-holds-lock-across-put bug stays dead.

Policy tests drive the scheduler manually (autostart=False + step(force=
True)) so they are deterministic; no sleeps for correctness, only for
cross-thread handoff. Every wait has a timeout.

Beyond the reference's cases: slot_geometry and the registry's max_slot
against the reference's, the v1 FrontDoor shim, a scheduler tenant under
a consensus fault plan, and serve_gp's --scheduler and --async-door runs
on the CPU. The fleets are float64 on the CPU at the widths of
tests/test_torch_methods.py.
"""
import re
import threading
import time
from concurrent.futures import CancelledError
from functools import partial

import numpy as np
import pytest
import torch

from repro.fleet import get_method as jget_method
from repro_torch.chaos import Dropout, FaultPlan
from repro_torch.core.gp import stripe_partition
from repro_torch.fleet import FleetConfig, GPFleet, method_names
from repro_torch.launch import serve_gp
from repro_torch.launch.frontdoor import FrontDoor
from repro_torch.launch.scheduler import (DeadlineExceeded, SchedulerClosed,
                                          SchedulerSaturated,
                                          ServingScheduler, Tenant,
                                          slot_ladder, pick_slot)
from repro_torch.obs import parse_prometheus_text, prometheus_text

torch.set_num_threads(2)

TRUE_THETA = (1.2, 0.3, 1.3, 0.1)


def random_inputs(seed, n):
    """n query rows uniform on [0, 2)^2 (what a client sends: host numpy)."""
    return np.random.default_rng(seed).uniform(0.0, 2.0, (n, 2))


def echo_predict(Xs):
    """Deterministic stand-in engine: mean = sum over features, var = 1."""
    Xs = np.asarray(Xs)
    return Xs.sum(axis=-1), np.ones(Xs.shape[0])


def manual_sched(**kw):
    return ServingScheduler(autostart=False, **kw)


# ---------------------------------------------------------------------------
# slot geometry
# ---------------------------------------------------------------------------

def test_slot_ladder_doubles_to_max():
    assert slot_ladder(8, 64) == (8, 16, 32, 64)
    assert slot_ladder(8, 50) == (8, 16, 32, 50)   # max always included
    assert slot_ladder(16, 16) == (16,)
    assert slot_ladder(32, 8) == (8,)              # max below align: pinned
    with pytest.raises(ValueError):
        slot_ladder(0, 64)
    with pytest.raises(ValueError):
        slot_ladder(8, -1)


def test_pick_slot_exact_round_down_bounded_round_up_pad():
    slots = (8, 16, 32)
    assert pick_slot(slots, 8) == 8        # exact ladder fit
    assert pick_slot(slots, 16) == 16
    assert pick_slot(slots, 9) == 8        # round DOWN: 8 full rows now,
    assert pick_slot(slots, 11) == 8       # remainder rides the next step
    assert pick_slot(slots, 13) == 16      # >= 75% of the slot up: round UP,
    assert pick_slot(slots, 31) == 32      # clear the backlog, bounded pad
    assert pick_slot(slots, 1) == 8        # below the smallest slot: pad
    assert pick_slot(slots, 32) == 32
    assert pick_slot(slots, 1000) == 32
    assert pick_slot(slots, 13, pad_budget=0.0) == 8   # strict round-down


def test_tenant_validates_policies():
    with pytest.raises(ValueError, match="admission"):
        Tenant("t", echo_predict, (8,), queue_depth=8, admission="maybe",
               deadline_policy="drop", max_wait_s=0.01)
    with pytest.raises(ValueError, match="deadline_policy"):
        Tenant("t", echo_predict, (8,), queue_depth=8, admission="block",
               deadline_policy="shrug", max_wait_s=0.01)
    with pytest.raises(ValueError, match="slots"):
        Tenant("t", echo_predict, (), queue_depth=8, admission="block",
               deadline_policy="drop", max_wait_s=0.01)


# ---------------------------------------------------------------------------
# continuous batching semantics (manual stepping, echo engine)
# ---------------------------------------------------------------------------

def test_ragged_requests_stitched_in_order():
    sched = manual_sched()
    sched.add_tenant("t", echo_predict, slots=(4, 8))
    rng = np.random.default_rng(0)
    reqs = [rng.uniform(size=(int(n), 3)) for n in rng.integers(1, 7, 9)]
    futs = [sched.add_request(r) for r in reqs]
    while sched.step(force=True):
        pass
    for r, fut in zip(reqs, futs):
        mean, var = fut.result(timeout=0)
        np.testing.assert_allclose(mean, r.sum(axis=-1), atol=1e-12)
        assert var.shape == (r.shape[0],)
    sched.close()


def test_large_request_spans_slots():
    """A request bigger than the largest slot streams across steps and is
    reassembled; intermediate steps leave the future unresolved."""
    sched = manual_sched()
    sched.add_tenant("t", echo_predict, slots=(4,))
    Xq = np.arange(11.0 * 2).reshape(11, 2)     # 11 rows over 4-row slots
    fut = sched.add_request(Xq)
    assert sched.step(force=True) and not fut.done()
    assert sched.step(force=True) and not fut.done()
    assert sched.step(force=True) and fut.done()
    mean, _ = fut.result(timeout=0)
    np.testing.assert_allclose(mean, Xq.sum(axis=-1), atol=1e-12)
    st = sched.stats
    assert st.batches == 3 and st.queries == 11 and st.padded_queries == 1
    sched.close()


def test_padding_fraction_counts_pad_rows():
    sched = manual_sched()
    sched.add_tenant("t", echo_predict, slots=(8,))
    sched.add_request(np.zeros((3, 2)))
    sched.step(force=True)            # 3 real rows + 5 pad rows
    st = sched.stats
    assert st.queries == 3 and st.padded_queries == 5
    assert st.padding_fraction == pytest.approx(5 / 8)
    sched.close()


def test_priority_orders_packing():
    """Higher priority packs first; FIFO within a priority level."""
    served = []

    def spy(Xs):
        served.append(int(np.asarray(Xs)[0, 0]))
        return echo_predict(Xs)

    sched = manual_sched()
    sched.add_tenant("t", spy, slots=(2,))
    tagged = lambda tag: np.full((2, 1), float(tag))
    sched.add_request(tagged(0), priority=0)
    sched.add_request(tagged(1), priority=5)
    sched.add_request(tagged(2), priority=5)
    sched.add_request(tagged(3), priority=9)
    while sched.step(force=True):
        pass
    assert served == [3, 1, 2, 0]
    sched.close()


def test_round_robin_interleaves_tenants():
    served = []
    mk = lambda name: (lambda Xs, n=name: (served.append(n),
                                           echo_predict(Xs))[1])
    sched = manual_sched()
    sched.add_tenant("a", mk("a"), slots=(4,))
    sched.add_tenant("b", mk("b"), slots=(4,))
    for _ in range(3):
        sched.add_request(np.zeros((4, 2)), tenant="a")
        sched.add_request(np.zeros((4, 2)), tenant="b")
    while sched.step(force=True):
        pass
    assert served == ["a", "b", "a", "b", "a", "b"]
    sched.close()


def test_engine_error_fails_every_rider():
    def boom(_):
        raise RuntimeError("engine exploded")

    sched = manual_sched()
    sched.add_tenant("t", boom, slots=(8,))
    futs = [sched.add_request(np.zeros((2, 2))) for _ in range(3)]
    sched.step(force=True)
    for fut in futs:
        with pytest.raises(RuntimeError, match="exploded"):
            fut.result(timeout=0)
    sched.close()


def test_request_validation():
    sched = manual_sched()
    sched.add_tenant("t", echo_predict, slots=(4,))
    with pytest.raises(ValueError, match=r"\(Nq, D\)"):
        sched.add_request(np.zeros(3))
    with pytest.raises(ValueError, match="at least one"):
        sched.add_request(np.zeros((0, 2)))
    with pytest.raises(KeyError, match="unknown tenant"):
        sched.add_request(np.zeros((1, 2)), tenant="nope")
    sched.add_tenant("u", echo_predict, slots=(4,))
    with pytest.raises(ValueError, match="tenant= is required"):
        sched.add_request(np.zeros((1, 2)))      # ambiguous: 2 tenants
    with pytest.raises(ValueError, match="single-tenant"):
        sched.stats
    sched.close()


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

def test_deadline_drop():
    sched = manual_sched()
    sched.add_tenant("t", echo_predict, slots=(4,), deadline_policy="drop")
    late = sched.add_request(np.zeros((2, 2)), deadline_ms=0.01)
    ok = sched.add_request(np.ones((2, 2)))
    time.sleep(0.005)                  # let the 10us deadline lapse
    sched.step(force=True)
    with pytest.raises(DeadlineExceeded):
        late.result(timeout=0)
    assert ok.result(timeout=0)[0].shape == (2,)
    st = sched.stats
    assert st.dropped == 1 and st.queries == 2
    sched.close()


def test_deadline_deprioritize_serves_lapsed_last():
    served = []

    def spy(Xs):
        served.append(int(np.asarray(Xs)[0, 0]))
        return echo_predict(Xs)

    sched = manual_sched()
    sched.add_tenant("t", spy, slots=(2,), deadline_policy="deprioritize")
    late = sched.add_request(np.full((2, 1), 7.0), deadline_ms=0.01,
                             priority=100)
    time.sleep(0.005)
    fresh = sched.add_request(np.full((2, 1), 1.0), priority=0)
    while sched.step(force=True):
        pass
    # the lapsed request lost its priority but was still served (after the
    # in-deadline work), not dropped
    assert served == [1, 7]
    assert fresh.result(timeout=0)[0].shape == (2,)
    assert late.result(timeout=0)[0].shape == (2,)
    st = sched.stats
    assert st.lapsed == 1 and st.dropped == 0
    sched.close()


def test_started_request_is_always_finished():
    """Deadline expiry mid-stream never abandons a partially-served
    request (policy=drop only applies before the first row dispatches)."""
    sched = manual_sched()
    sched.add_tenant("t", echo_predict, slots=(4,), deadline_policy="drop")
    fut = sched.add_request(np.zeros((6, 2)), deadline_ms=50.0)
    sched.step(force=True)             # rows 0-3 dispatched in-deadline
    time.sleep(0.06)                   # now past the deadline, 2 rows left
    sched.step(force=True)
    assert fut.result(timeout=0)[0].shape == (6,)
    assert sched.stats.dropped == 0
    sched.close()


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

def test_admission_reject_raises_saturated():
    sched = manual_sched()
    sched.add_tenant("t", echo_predict, slots=(4,), queue_depth=8,
                     admission="reject")
    sched.add_request(np.zeros((8, 2)))
    with pytest.raises(SchedulerSaturated):
        sched.add_request(np.zeros((1, 2)))
    assert sched.stats.rejected == 1
    sched.step(force=True)             # drain one slot -> space again
    sched.step(force=True)
    sched.add_request(np.zeros((8, 2)))
    sched.close()


def test_backpressure_blocks_then_resumes():
    """admission='block': an over-depth submit parks on the condition and
    completes once a step frees queue space."""
    sched = manual_sched()
    sched.add_tenant("t", echo_predict, slots=(4,), queue_depth=4,
                     admission="block")
    sched.add_request(np.zeros((4, 2)))
    state = {}

    def blocked_submit():
        state["fut"] = sched.add_request(np.ones((4, 2)))

    th = threading.Thread(target=blocked_submit)
    th.start()
    time.sleep(0.05)
    assert th.is_alive()               # backpressure engaged
    sched.step(force=True)             # frees 4 rows -> waiter admitted
    th.join(timeout=10.0)
    assert not th.is_alive()
    sched.step(force=True)
    assert state["fut"].result(timeout=0)[0].shape == (4,)
    sched.close()


def test_close_wakes_blocked_submitter():
    """close() must wake a submitter parked on backpressure with
    SchedulerClosed — the v1 deadlock (submit holding the lifecycle lock
    across a blocking queue put) is structurally impossible."""
    sched = manual_sched()
    sched.add_tenant("t", echo_predict, slots=(4,), queue_depth=4,
                     admission="block")
    sched.add_request(np.zeros((4, 2)))
    errs = []

    def blocked_submit():
        try:
            sched.add_request(np.ones((4, 2)))
        except SchedulerClosed as e:
            errs.append(e)

    th = threading.Thread(target=blocked_submit)
    th.start()
    time.sleep(0.05)
    assert th.is_alive()
    sched.close(drain=False)           # must not deadlock
    th.join(timeout=10.0)
    assert not th.is_alive() and len(errs) == 1


def test_deadline_drops_free_queue_space():
    """A deadline drop releases its rows toward queue_depth (a waiter
    blocked on backpressure is admitted even though nothing was served)."""
    sched = manual_sched()
    sched.add_tenant("t", echo_predict, slots=(4,), queue_depth=4,
                     admission="block", deadline_policy="drop")
    doomed = sched.add_request(np.zeros((4, 2)), deadline_ms=0.01)
    time.sleep(0.005)
    admitted = []
    th = threading.Thread(
        target=lambda: admitted.append(sched.add_request(np.ones((4, 2)))))
    th.start()
    time.sleep(0.05)
    assert th.is_alive()
    sched.step(force=True)             # drops the lapsed request
    th.join(timeout=10.0)
    assert not th.is_alive() and len(admitted) == 1
    with pytest.raises(DeadlineExceeded):
        doomed.result(timeout=0)
    sched.close()


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def test_close_drain_false_cancels_riders():
    sched = manual_sched()
    sched.add_tenant("t", echo_predict, slots=(4,))
    futs = [sched.add_request(np.zeros((2, 2))) for _ in range(3)]
    sched.close(drain=False)
    for fut in futs:
        assert fut.cancelled()
        with pytest.raises(CancelledError):
            fut.result(timeout=0)
    with pytest.raises(SchedulerClosed):
        sched.add_request(np.zeros((1, 2)))


def test_close_drain_false_fails_partial_request_explicitly():
    """A request with rows already streamed cannot be silently cancelled —
    it gets SchedulerClosed so the caller knows rows were dispatched."""
    sched = manual_sched()
    sched.add_tenant("t", echo_predict, slots=(4,))
    fut = sched.add_request(np.zeros((6, 2)))
    sched.step(force=True)             # 4 of 6 rows served; 2 carried
    sched.close(drain=False)
    with pytest.raises(SchedulerClosed):
        fut.result(timeout=0)


def test_close_drain_serves_everything():
    sched = ServingScheduler(max_wait_ms=1.0)     # real worker thread
    sched.add_tenant("t", echo_predict, slots=(4, 8))
    futs = [sched.add_request(np.full((3, 2), float(i))) for i in range(5)]
    sched.close()                      # drain=True
    for i, fut in enumerate(futs):
        mean, _ = fut.result(timeout=0)
        np.testing.assert_allclose(mean, np.full(3, 2.0 * i), atol=1e-12)


def test_worker_thread_serves_without_stepping():
    """autostart=True: the background worker dispatches on its own once
    max_wait expires; no manual step() calls anywhere."""
    with ServingScheduler(max_wait_ms=1.0) as sched:
        sched.add_tenant("t", echo_predict, slots=(16,))
        fut = sched.add_request(np.ones((3, 2)))
        mean, _ = fut.result(timeout=60)
        np.testing.assert_allclose(mean, np.full(3, 2.0), atol=1e-12)


# ---------------------------------------------------------------------------
# two resident GPFleet tenants, zero recompiles (acceptance gate)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_fleets():
    M = 4
    X = torch.from_numpy(random_inputs(0, 256))
    rng = np.random.default_rng(1)
    y = torch.from_numpy(np.sin(3 * X[:, 0].numpy()) * np.cos(X[:, 1].numpy())
                         + 0.1 * rng.standard_normal(256))
    Xp, yp = stripe_partition(X, y, M)
    mk = lambda method: GPFleet(
        FleetConfig(num_agents=M, method=method, chunk=8, dac_iters=40,
                    theta0=TRUE_THETA), device="cpu"
    ).fit(Xp, yp, train=False)
    return mk("rbcm"), mk("poe")


def test_two_fleet_tenants_zero_recompiles(two_fleets):
    """The headline gate: two fleets resident in one scheduler, 14 ragged
    requests each, every dispatch hits a warm jit cache (miss counters are
    flat after registration warmup), answers match direct predicts."""
    fa, fb = two_fleets
    rng = np.random.default_rng(7)
    with ServingScheduler(max_wait_ms=1.0) as sched:
        sched.add_fleet("maps", fa, max_slot=32)
        sched.add_fleet("robots", fb, max_slot=32)
        misses = {"maps": fa.jit_cache_misses, "robots": fb.jit_cache_misses}
        assert misses["maps"] > 0       # warmup did trace the ladder
        futs = []
        for i in range(14):
            n = int(rng.integers(1, 40))
            Xq = random_inputs(100 + i, n)
            name = ("maps", "robots")[i % 2]
            futs.append((name, Xq, sched.add_request(Xq, tenant=name)))
        results = [(name, Xq, fut.result(timeout=300))
                   for name, Xq, fut in futs]
        assert fa.jit_cache_misses == misses["maps"]       # ZERO recompiles
        assert fb.jit_cache_misses == misses["robots"]
        stats = sched.tenant_stats
        assert stats["maps"].requests == 7
        assert stats["robots"].requests == 7
    for name, Xq, (mean, var) in results:
        fleet = fa if name == "maps" else fb
        ref_m, ref_v, _ = fleet.predict(Xq)
        np.testing.assert_allclose(mean, np.asarray(ref_m), atol=1e-8)
        np.testing.assert_allclose(var, np.asarray(ref_v), atol=1e-8)


def test_to_server_returns_scheduler(two_fleets):
    """GPFleet.to_server() is now a one-tenant scheduler keeping the v1
    FrontDoor submit/stats surface."""
    fa, _ = two_fleets
    with fa.to_server(batch=16) as srv:
        assert isinstance(srv, ServingScheduler)
        misses = fa.jit_cache_misses
        futs = [srv.submit(random_inputs(i, 1 + i)) for i in range(4)]
        for fut in futs:
            fut.result(timeout=300)
        assert fa.jit_cache_misses == misses
        assert srv.stats.requests == 4


def test_fleet_slot_geometry(two_fleets):
    fa, _ = two_fleets
    align, max_slot = fa.slot_geometry()
    assert align == 8                       # engine chunk
    assert max_slot >= align
    # NPAE's per-query (M, M) solves cap its slot ceiling below the default
    from repro_torch.fleet import get_method
    assert get_method("npae").max_slot < get_method("rbcm").max_slot


# ---------------------------------------------------------------------------
# fault tolerance: retries, per-rider isolation, stall watchdog, bounded close
# ---------------------------------------------------------------------------

def test_retry_recovers_transient_failure():
    calls = {"n": 0}

    def flaky(Xs):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError("transient")
        return echo_predict(Xs)

    sched = manual_sched()
    sched.add_tenant("t", flaky, slots=(4,), retries=2,
                     retry_backoff_ms=0.1)
    fut = sched.add_request(np.ones((3, 2)))
    sched.step(force=True)
    mean, _ = fut.result(timeout=0)
    np.testing.assert_allclose(mean, np.full(3, 2.0), atol=1e-12)
    assert sched.stats.retried == 2
    sched.close()


def test_retries_exhausted_surface_last_exception():
    def boom(_):
        raise RuntimeError("permanent")

    sched = manual_sched()
    sched.add_tenant("t", boom, slots=(4,), retries=1,
                     retry_backoff_ms=0.1, isolate=False)
    fut = sched.add_request(np.zeros((2, 2)))
    sched.step(force=True)
    with pytest.raises(RuntimeError, match="permanent"):
        fut.result(timeout=0)
    assert sched.stats.retried == 1
    sched.close()


def test_isolation_fails_only_the_poisoned_rider():
    """Two requests share a slot; one carries a poisoned row. The shared
    dispatch fails, isolation re-runs each rider alone, and only the
    poisoned request sees the exception."""
    def picky(Xs):
        if np.any(np.asarray(Xs) >= 999.0):
            raise RuntimeError("poisoned payload")
        return echo_predict(Xs)

    sched = manual_sched()
    sched.add_tenant("t", picky, slots=(8,), retries=0,
                     retry_backoff_ms=0.1, isolate=True)
    good = sched.add_request(np.ones((2, 2)))
    bad = sched.add_request(np.full((2, 2), 999.0))
    sched.step(force=True)                 # both packed into one 8-slot
    mean, _ = good.result(timeout=0)
    np.testing.assert_allclose(mean, np.full(2, 2.0), atol=1e-12)
    with pytest.raises(RuntimeError, match="poisoned"):
        bad.result(timeout=0)
    assert sched.stats.isolated == 1       # the healthy rider's solo run
    sched.close()


def test_isolate_false_fails_the_whole_slot():
    def picky(Xs):
        if np.any(np.asarray(Xs) >= 999.0):
            raise RuntimeError("poisoned payload")
        return echo_predict(Xs)

    sched = manual_sched()
    sched.add_tenant("t", picky, slots=(8,), retries=0, isolate=False)
    good = sched.add_request(np.ones((2, 2)))
    bad = sched.add_request(np.full((2, 2), 999.0))
    sched.step(force=True)
    for fut in (good, bad):
        with pytest.raises(RuntimeError, match="poisoned"):
            fut.result(timeout=0)
    sched.close()


def test_watchdog_fails_stalled_dispatch_and_recovers():
    """A dispatch wedged inside predict_fn past the stall timeout: the
    watchdog fails its riders with SchedulerStalled, quarantines the
    tenant (admission rejects), respawns the worker — and when the stuck
    call finally returns, the tenant serves again."""
    from repro_torch.launch.scheduler import SchedulerStalled
    release = threading.Event()
    wedged = {"on": True}

    def sticky(Xs):
        if wedged["on"]:
            release.wait(timeout=30)
        return echo_predict(Xs)

    sched = ServingScheduler(max_wait_ms=0.5, stall_timeout_ms=60)
    sched.add_tenant("t", sticky, slots=(4,))
    fut = sched.add_request(np.ones((2, 2)))
    with pytest.raises(SchedulerStalled):
        fut.result(timeout=30)             # watchdog fired
    assert sched.stats.stalled == 1
    # quarantined while the stuck thread is still inside predict_fn
    with pytest.raises(SchedulerStalled, match="quarantined"):
        sched.add_request(np.ones((1, 2)))
    wedged["on"] = False
    release.set()                          # stuck call returns -> recovery
    deadline = time.perf_counter() + 30
    while time.perf_counter() < deadline:
        try:
            fut2 = sched.add_request(np.ones((3, 2)))
            break
        except SchedulerStalled:
            time.sleep(0.01)
    mean, _ = fut2.result(timeout=30)
    np.testing.assert_allclose(mean, np.full(3, 2.0), atol=1e-12)
    sched.close()


def test_close_is_bounded_with_wedged_tenant():
    """close(drain=True, timeout=) must return even when a dispatch never
    comes back — the in-flight rider is failed, not stranded."""
    release = threading.Event()

    def stuck(Xs):
        release.wait(timeout=60)
        return echo_predict(Xs)

    sched = ServingScheduler(max_wait_ms=0.5)
    sched.add_tenant("t", stuck, slots=(4,))
    fut = sched.add_request(np.ones((2, 2)))
    deadline = time.perf_counter() + 10    # wait until it is in flight
    while time.perf_counter() < deadline:
        with sched._lock:
            if sched._tenants["t"].inflight:
                break
        time.sleep(0.005)
    t0 = time.perf_counter()
    sched.close(drain=True, timeout=1.0)
    assert time.perf_counter() - t0 < 8.0
    with pytest.raises(SchedulerClosed):
        fut.result(timeout=0)
    release.set()                          # let the wedged thread exit


# ---------------------------------------------------------------------------
# beyond the reference's cases
# ---------------------------------------------------------------------------

def test_slot_geometry_and_max_slot_match_the_reference(two_fleets):
    """Every registered method's slot ceiling is the reference's, so a
    fleet's ladder is the reference's: (chunk, max_slot)."""
    fa, _ = two_fleets
    for m in method_names():
        assert fa.slot_geometry(m) == (8, jget_method(m).max_slot), m
        assert fa.slot_geometry(f"cen_{m}") == fa.slot_geometry(m)
    assert slot_ladder(*fa.slot_geometry("npae")) == (8, 16, 32, 64, 128,
                                                      256)


def test_frontdoor_shim_serves_the_engine(two_fleets):
    """The v1 FrontDoor: one fixed (batch, D) geometry, stats and close."""
    fa, _ = two_fleets
    with FrontDoor(partial(fa.engine.predict, "rbcm"), batch=16) as door:
        reqs = [random_inputs(40 + i, n) for i, n in enumerate((3, 16, 21))]
        futs = [door.submit(r) for r in reqs]
        answers = [f.result(timeout=60) for f in futs]
    for r, (mean, var) in zip(reqs, answers):
        ref_m, ref_v, _ = fa.predict(r)
        np.testing.assert_allclose(mean, ref_m.numpy(), atol=1e-8)
        np.testing.assert_allclose(var, ref_v.numpy(), atol=1e-8)
    st = door.stats
    assert st.requests == 3 and st.queries == 40
    assert (st.queries + st.padded_queries) % 16 == 0
    with pytest.raises(SchedulerClosed):
        door.submit(reqs[0])


def test_fault_plan_tenant_serves_degraded_without_new_geometry(two_fleets):
    """A consensus-fault tenant warms its degraded geometries at
    registration; the answers are the fleet's degraded predictions and
    the serving faults (fail_every) are retried away."""
    fa, _ = two_fleets
    plan = FaultPlan(dropouts=(Dropout(0),), fail_every=3)
    with ServingScheduler(max_wait_ms=1.0) as sched:
        tenant = sched.add_fleet("chaos", fa, max_slot=32, fault_plan=plan,
                                 retry_backoff_ms=0.1)
        misses = fa.jit_cache_misses
        reqs = [random_inputs(60 + i, 5 + 7 * i) for i in range(5)]
        futs = [sched.add_request(r, tenant="chaos") for r in reqs]
        answers = [f.result(timeout=120) for f in futs]
        assert fa.jit_cache_misses == misses
        assert tenant.stats.retried >= 1
        metrics = parse_prometheus_text(prometheus_text())
    for r, (mean, _) in zip(reqs, answers):
        ref = fa.predict(r, fault_plan=plan, allow_degraded=True)
        assert ref[2]["degraded"] and ref[2]["alive_agents"] == 3
        np.testing.assert_allclose(mean, ref[0].numpy(), atol=1e-8)
    assert any(labels.get("tenant") == "chaos" and v >= 5
               for labels, v in metrics["gp_completed_total"])


def test_serve_gp_scheduler_with_faults_on_the_cpu(tmp_path, capsys):
    trace = tmp_path / "spans.jsonl"
    serve_gp.main(["--device", "cpu", "--agents", "4", "--per-agent", "40",
                   "--chunk", "16", "--batch", "64", "--dac-iters", "40",
                   "--scheduler", "--loadgen", "20", "--duration", "0.5",
                   "--fault-dropout", "0", "--fault-fail-every", "5",
                   "--trace-log", str(trace), "--metrics-port", "0"])
    out = capsys.readouterr().out
    m = re.search(r"-> (\d+) submitted: (\d+) served / 0 past-deadline / "
                  r"(\d+) rejected / 0 failed / 0 hung", out)
    assert m is not None, out
    submitted, served, rejected = map(int, m.groups())
    assert served > 0 and served == submitted - rejected, out
    rates = [int(q) for q in re.findall(r"\((\d+) q/s\)", out)]
    assert rates and min(rates) > 0, out
    assert "0 new geometries after warm-up" in out
    assert "fault plan: FaultPlan(" in out
    assert trace.exists()


def test_serve_gp_two_tenants_and_async_door_on_the_cpu(capsys):
    serve_gp.main(["--device", "cpu", "--agents", "4", "--per-agent", "40",
                   "--chunk", "16", "--batch", "32", "--dac-iters", "40",
                   "--scheduler", "--requests", "6", "--tenant", "a=rbcm",
                   "--tenant", "b=nn-poe"])
    out = capsys.readouterr().out
    assert "2 tenant(s)" in out and "0 hung" in out
    serve_gp.main(["--device", "cpu", "--agents", "4", "--per-agent", "40",
                   "--chunk", "16", "--batch", "32", "--dac-iters", "40",
                   "--requests", "6", "--async-door"])
    assert "async rbcm: 6 requests" in capsys.readouterr().out
