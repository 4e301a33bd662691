"""gpbench/spans.py, the split of a traced slice by the program's layer
spans: fabricated device activities, runtime calls, probes and spans give
known device and idle seconds, which add up with the unattributed ones to
the slice's device total and its clipped idle time exactly, the
unattributed idle never negative and the difference from trace.py's idle
the device activity outside the slice; a traced tiny cell on the CPU (no
device activity) reads None in every span metric; on the card the spans
leave a tiny traced run's device activity as it was."""
import json
import random
import sys
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parents[1]), str(HERE)]

import gpbench_tiny as T  # noqa: E402
from gpbench import harness, spans  # noqa: E402
from gpbench.readings import device_total, idle  # noqa: E402

PROBE = "repro_torch.obs"
SPAN_METRICS = {
    "tiny.serve": ("dac_share.serve", "idle_consensus.serve",
                   "idle_engine.serve", "idle_frontdoor.serve"),
    "tiny.train": ("factor_share.train", "inverse_share.train"),
    "tiny-window.stream": ("alpha_share.stream", "idle_ingest.stream"),
}


class Event:
    """What spans.py reads of a profiler event."""

    def __init__(self, name, start, end, kind=DeviceType.CPU, corr=0,
                 thread=1):
        self._name, self._s, self._e = name, start, end
        self._kind, self._corr, self._thread = kind, corr, thread

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return self._kind

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return self._thread


class Rec:
    """What spans.py reads of a span record (Unix ns, the trace's
    clock)."""

    def __init__(self, name, start, end, tid=100, **fields):
        self.name, self.start, self.end = name, start, end
        self.tid, self.fields = tid, fields


def kernel(start, end, corr):
    return Event(f"kernel{corr}", start, end, DeviceType.CUDA, corr)


def launch(t, corr, thread=1):
    return Event("cudaLaunchKernel", t, t + 10, corr=corr, thread=thread)


def probe(t, tid=100, thread=1, index=0):
    name = f"{PROBE}#{tid}#{index}"
    return Rec(name, t, t, tid), Event(name, t - 5, t + 5, thread=thread)


def fabricated():
    """Thread 100 (the profiler's 1): A [2000, 10000] holds B [3000,
    6000]; a wait with nothing pending [10000, 14000]. Kernels: 1 (launched
    in A) [4000, 5000], 2 (in B) [5000, 7000], 3 (launched outside any
    span) [14500, 15000], 4 (no runtime call) [15000, 15500]. The slice
    is [2000, 16000]."""
    p_rec, p_ev = probe(1000)
    records = [p_rec, Rec("A", 2000, 10000), Rec("B", 3000, 6000),
               Rec("frontdoor.wait", 10000, 14000, pending=0)]
    events = [p_ev, launch(2500, 1), launch(3500, 2), launch(14200, 3),
              kernel(4000, 5000, 1), kernel(5000, 7000, 2),
              kernel(14500, 15000, 3), kernel(15000, 15500, 4)]
    return events, records


def test_fabricated_slice_splits_as_by_hand():
    events, records = fabricated()
    # busy: [4000, 7000] and [14500, 15500]
    out = spans.attribute(events, records, PROBE, 2000, 14000e-9, 4000e-9)
    dev, under, idle_s = out["device_s"], out["under_s"], out["idle_s"]
    assert dev["A"] == pytest.approx(1000e-9)
    assert dev["B"] == pytest.approx(2000e-9)
    assert dev["unattributed"] == pytest.approx(1000e-9)
    assert under["A"] == pytest.approx(3000e-9)
    assert under["B"] == pytest.approx(2000e-9)
    # idle: [2000, 4000] = A 1000 + B 1000; [7000, 14500] = A 3000 + wait
    # 4000 + none 500; [15500, 16000] none
    assert idle_s["A"] == pytest.approx(4000e-9)
    assert idle_s["B"] == pytest.approx(1000e-9)
    assert idle_s["frontdoor.wait:no_work"] == pytest.approx(4000e-9)
    assert idle_s["unattributed"] == pytest.approx(1000e-9)
    assert out["launch_tid"] == 100 and out["span_images"] == 0
    assert out["device_total_s"] == pytest.approx(4000e-9)
    assert out["idle_total_s"] == pytest.approx(10000e-9)
    assert out["idle_off_trace_s"] == pytest.approx(0, abs=1e-15)
    assert out["clock_skew_us"] == 0


def test_a_probe_read_off_its_range_is_the_clock_skew():
    events, records = fabricated()
    records[0].start = records[0].end = 1000 + 2005
    out = spans.attribute(events, records, PROBE, 2000, 14000e-9, 4000e-9)
    assert out["clock_skew_us"] == pytest.approx(2.0)


def test_a_pending_wait_is_the_hold():
    events, records = fabricated()
    records[3].fields["pending"] = 32
    out = spans.attribute(events, records, PROBE, 2000, 14000e-9, 4000e-9)
    assert out["idle_s"]["frontdoor.wait:hold"] == pytest.approx(4000e-9)
    assert "frontdoor.wait:no_work" not in out["idle_s"]


def test_no_device_activity_or_no_probe_reads_nothing():
    events, records = fabricated()
    host_only = [e for e in events if e.device_type() != DeviceType.CUDA]
    assert spans.attribute(host_only, records, PROBE, 2000, 1e-5, 0) is None
    assert spans.attribute(events, records[1:], PROBE, 2000, 1e-5,
                           4e-6) is None


def test_open_span_lasts_to_the_slice_end_and_images_are_counted():
    events, records = fabricated()
    records[3].end = None
    events.append(Event("B", 8000, 8100, DeviceType.CUDA, 99))
    out = spans.attribute(events, records, PROBE, 2000, 14000e-9, 4100e-9)
    assert out["span_images"] == 1
    # the open wait now also holds [14000, 14500] and [15500, 16000]
    assert out["idle_s"]["frontdoor.wait:no_work"] == pytest.approx(
        5000e-9)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_attributed_and_unattributed_add_up_exactly(seed):
    """Random nested spans on two threads, random launches and kernels,
    some of them outside the slice: the split's device seconds add up to
    the device total, its idle seconds to the slice less the union of the
    device activities clipped to it, both exactly; the unattributed idle
    is never negative, and trace.py's idle (busy unclipped) differs from
    it by the device activity outside the slice."""
    rng = random.Random(seed)
    events, records, corr = [], [], 0
    for tid, thread in ((100, 1), (200, 2)):
        t = 0
        for i in range(6):
            pc = t + rng.randrange(1000)
            rec, ev = probe(pc, tid, thread, i)
            records.append(rec)
            events.append(ev)
            outer_end = pc + 20000
            records.append(Rec("outer", pc + 100, outer_end, tid))
            a = pc + 200
            for _ in range(rng.randrange(1, 5)):
                b = a + rng.randrange(100, 3000)
                if b >= outer_end:
                    break
                records.append(Rec(rng.choice(("x", "y", "frontdoor.wait")),
                                   a, b, tid, pending=rng.randrange(2)))
                a = b + rng.randrange(50)
            t = outer_end + rng.randrange(5000)
    for _ in range(200):
        corr += 1
        t = rng.randrange(130000)
        thread = rng.choice((1, 2))
        if rng.random() < 0.9:
            events.append(launch(t, corr, thread))
        s = t + rng.randrange(5000)
        events.append(kernel(s, s + rng.randrange(1, 3000), corr))
    dev = [(e._s, e._e) for e in events if e._kind == DeviceType.CUDA]
    segs = spans._segments([(s, e, 0) for s, e in dev])
    t0, window = 6000, 115000
    busy_in = sum(e - s for s, e in spans._clip(segs, t0, t0 + window))
    busy_all = sum(e - s for s, e in segs)
    assert busy_all > busy_in
    out = spans.attribute(events, records, PROBE, t0, window * 1e-9,
                          busy_all * 1e-9)
    assert sum(out["device_s"].values()) == pytest.approx(
        out["device_total_s"], rel=1e-12, abs=0)
    assert out["device_total_s"] == pytest.approx(
        sum(e - s for s, e in dev) * 1e-9, rel=1e-12)
    idle_ns = {k: round(v * 1e9) for k, v in out["idle_s"].items()}
    assert sum(idle_ns.values()) == window - busy_in
    assert out["idle_total_s"] == pytest.approx((window - busy_in) * 1e-9)
    assert out["idle_off_trace_s"] == pytest.approx(
        (busy_all - busy_in) * 1e-9)
    assert idle_ns["unattributed"] >= 0
    assert sum(v for k, v in idle_ns.items() if k != "unattributed") > 0
    assert out["clock_skew_us"] == 0
    assert all(v >= 0 for k, v in out["device_s"].items()
               if k != "unattributed")


def test_flatten_keeps_the_innermost_and_its_ancestors():
    recs = [Rec("a", 0, 100), Rec("b", 10, 50), Rec("c", 20, 30),
            Rec("d", 60, 200)]          # d runs past its parent: clipped
    flat = [(a, b, r.name, tuple(sorted(p)))
            for a, b, r, p in spans.flatten(recs)]
    assert flat == [(0, 10, "a", ("a",)), (10, 20, "b", ("a", "b")),
                    (20, 30, "c", ("a", "b", "c")), (30, 50, "b", ("a", "b")),
                    (50, 60, "a", ("a",)), (60, 100, "d", ("a", "d"))]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny copy: make_copy points every metric that lists a paper
    cell, the nine span metrics among them, at the tiny cell too."""
    root = T.make_copy(tmp_path_factory.mktemp("bench_spans"))
    m = json.loads((root / "BENCHMARK.json").read_text())
    for cell, names in SPAN_METRICS.items():
        for name in names:
            entry = next(e for e in m["per_layer"] if e["name"] == name)
            assert cell in entry["workloads"]
            assert entry["source"] == "program_span"
    return root


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_traced_tiny_cell_reads_none_on_the_cpu(root, cell):
    run, line = T.run_cell(root, cell, seconds=0.6, trace=True)
    assert line["correct"] is True, line["checks"]
    for name in SPAN_METRICS[cell]:
        reader = harness.load_module(run.metric_dir / f"{name}.py")
        assert reader.read(run) is None
        assert name not in line["metrics"]
    assert run.span_split is None and "spans" not in run.layer
    # the slice's records were drained: nothing of the run is left behind
    from repro_torch.obs import tracing
    assert tracing.drain()[0] == []


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["tiny.serve", "tiny.train"])
def test_spans_leave_the_device_trace_as_it_was(root, monkeypatch, cell):
    """On the card: a tiny cell traced with the spans recording and with
    them switched off launches the same kernels (training: the same
    number of times, with the same busy time to within a quarter, run to
    run noise; serving: the slice's slots follow the clients' timing, so
    the counts differ); no device event carries a span's name, the split
    finds its spans, and the unattributed idle is not negative. Serving
    launches all its device work inside spans: nearly all of it is
    attributed (a tiny fit's cache and factors, outside the iterations,
    are a fifth of its device time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.obs import tracing

    def traced():
        run = harness.Run(root, cell, 3, 0.6, True, device="cuda")
        harness.execute(run)
        return run

    on = traced()
    split = spans.split(on)
    assert split is not None and split["span_images"] == 0
    assert split["idle_s"]["unattributed"] >= 0
    shares = (("train.factor", "train.inverse") if cell == "tiny.train"
              else ("engine.moments", "consensus.dac"))
    for name in shares:
        assert split["under_s"].get(name, 0) > 0, name

    # spans off under the profiler: the switch reads a module not loaded
    monkeypatch.setattr(tracing, "PROFILER_MODULE", "no.such.module")
    off = traced()
    assert tracing.drain()[0] == []
    a, b = on.layer["trace"], off.layer["trace"]
    if cell == "tiny.train":
        assert a["kernel_n"] == b["kernel_n"]
        assert a["busy_s"] == pytest.approx(b["busy_s"], rel=0.25)
    else:
        assert set(a["kernel_n"]) == set(b["kernel_n"])
        assert split["device_s"]["unattributed"] \
            < 0.05 * split["device_total_s"]
    assert idle(on) is not None and device_total(on) > 0
