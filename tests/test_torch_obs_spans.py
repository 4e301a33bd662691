"""The port's layer spans (repro_torch.obs.tracing.span and SpanRecorder)
on the CPU.

* Off, `span()` records nothing and hands out the shared no-op.
* On (`enable()`), each record's parent is the span open around it on its
  own thread, across two threads; the ring drops the oldest records and
  counts them; drains while eight threads record lose and double nothing.
* Under a CPU torch.profiler slice the spans record without `enable()`,
  and a span around `torch.mm`, on the trace's clock as recorded, lies on
  the `aten::mm` event's interval within 50 us, on the profiler's thread
  of that event as its thread's probe names it.
* The module imports no torch.
"""
import statistics
import subprocess
import sys
import threading
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.obs import tracing
from repro_torch.obs.tracing import NO_SPAN, PROBE, SpanRecorder


def _named(records, prefix):
    return [r for r in records if r.name.startswith(prefix)]


def test_off_records_nothing_and_returns_the_shared_no_op():
    tracing.drain()
    sp = tracing.span("test.off", rows=3)
    assert sp is NO_SPAN and not sp
    with tracing.span("test.off") as inner:
        assert inner is NO_SPAN
        assert inner.set(rows=1) is NO_SPAN
    assert _named(tracing.drain()[0], "test.off") == []


def test_parents_nest_on_each_thread():
    rec = SpanRecorder()
    rec.enable()
    barrier = threading.Barrier(2)

    def work(tag):
        with rec.span(f"{tag}.outer", slot=7):
            barrier.wait(timeout=10)
            with rec.span(f"{tag}.mid") as mid:
                mid.set(rows=4)
                barrier.wait(timeout=10)
                with rec.span(f"{tag}.inner"):
                    barrier.wait(timeout=10)
            with rec.span(f"{tag}.second"):
                pass

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    records, dropped = rec.drain()
    assert dropped == 0 and len(records) == 8
    by_name = {r.name: r for r in records}
    for tag in "ab":
        outer, mid, inner, second = (by_name[f"{tag}.{n}"] for n in
                                     ("outer", "mid", "inner", "second"))
        assert outer.parent == -1 and outer.fields == {"slot": 7}
        assert mid.parent == outer.index and mid.fields == {"rows": 4}
        assert inner.parent == mid.index
        assert second.parent == outer.index
        assert len({r.tid for r in (outer, mid, inner, second)}) == 1
        assert outer.start <= mid.start <= inner.start <= inner.end \
            <= mid.end <= second.start <= second.end <= outer.end
        assert outer.event()["span"] == f"{tag}.outer"
    assert by_name["a.outer"].tid != by_name["b.outer"].tid


def test_ring_drops_the_oldest_and_counts():
    rec = SpanRecorder(capacity=4)
    rec.enable()
    for i in range(10):
        with rec.span("test.ring", i=i):
            pass
    records, dropped = rec.drain()
    assert [r.fields["i"] for r in records] == [6, 7, 8, 9]
    assert [r.index for r in records] == [6, 7, 8, 9]
    assert dropped == 6
    assert rec.drain() == ([], 0)
    rec.disable()
    assert rec.span("test.ring") is NO_SPAN


def test_drains_while_threads_record_lose_nothing():
    rec = SpanRecorder()
    rec.enable()
    n_threads, n_spans = 8, 500
    drained, stop = [], threading.Event()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(n_spans):
                with rec.span("test.outer", i=i):
                    with rec.span("test.inner"):
                        pass

        def drain():
            while not stop.is_set():
                drained.extend(rec.drain()[0])

        drainer = threading.Thread(target=drain)
        drainer.start()
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        stop.set()
        drainer.join(timeout=60)
        assert not drainer.is_alive()
    finally:
        sys.setswitchinterval(old)
    records, dropped = rec.drain()
    drained.extend(records)
    assert dropped == 0
    assert len(drained) == 2 * n_threads * n_spans
    assert len({(r.tid, r.index) for r in drained}) == len(drained)
    assert all(r.end is not None for r in drained)


def test_profiler_switches_the_spans_on_and_off():
    tracing.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("test.profiled") as sp:
            assert sp is not NO_SPAN
    assert tracing.span("test.after") is NO_SPAN
    records, _ = tracing.drain()
    assert len(_named(records, "test.profiled")) == 1
    probes = _named(records, PROBE + "#")
    assert probes and probes[0].name.startswith(
        f"{PROBE}#{threading.get_native_id()}#")


def test_span_maps_through_the_probe_onto_the_trace():
    """A span around torch.mm lies on the aten::mm event: both ends within
    50 us (the median of 8) on the trace's clock, on the profiler's thread
    of that event, which the thread's probe names; the probe's own clock
    read lies within 50 us of its range."""
    a = torch.randn(96, 96)
    torch.mm(a, a)
    with torch.autograd.profiler.record_function("test.warm"):
        pass                          # the first range of a process is slow
    tracing.drain()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(8):
            with tracing.span("test.mm"):
                torch.mm(a, a)
    records, _ = tracing.drain()
    events = prof.profiler.kineto_results.events()
    probe = _named(records, PROBE + "#")[0]
    ev = next(e for e in events if e.name() == probe.name)
    assert ev.start_ns() - 50e3 <= probe.start <= ev.end_ns() + 50e3
    spans = sorted(_named(records, "test.mm"), key=lambda r: r.start)
    mms = sorted((e for e in events if e.name() == "aten::mm"),
                 key=lambda e: e.start_ns())
    assert len(spans) == len(mms) == 8
    errs = []
    for sp, mm in zip(spans, mms):
        assert mm.start_thread_id() == ev.start_thread_id()
        errs.append(max(abs(mm.start_ns() - sp.start),
                        abs(sp.end - mm.end_ns())))
    assert statistics.median(errs) < 50e3, errs


def test_the_module_imports_no_torch():
    """tracing.py loaded on its own leaves torch unimported; its spans
    still record under enable()."""
    path = Path(tracing.__file__)
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('t', {str(path)!r})\n"
        "t = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(t)\n"
        "assert t.span('x') is t.NO_SPAN\n"
        "t.enable()\n"
        "with t.span('x', n=1):\n"
        "    pass\n"
        "assert [r.name for r in t.drain()[0]] == ['x']\n"
        "assert 'torch' not in sys.modules, 'torch imported'\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
