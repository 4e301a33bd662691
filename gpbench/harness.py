"""One run of one cell: find the cell's files by name, set up, measure,
check the answers against the plain reference, read the per-layer
metrics, print the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
`BENCHMARK.json` gives it:

  configs/<config>.json      the configuration (the manifest's `file`)
  traffic/<traffic>.json     the mix; its "loop" names loops/<loop>.py
  limits/<workload>.json     the limit of each number the cell compares
  metrics/<metric>.py        `read(run) -> float | None` per per-layer metric

A loop module has `setup(run) -> state`, `window(run, state)`,
`release(run, state)` and `check(run, state)`; it fills `run.e2e` (the
end-to-end readings, host clock), `run.layer` (what the readers read) and
`run.checks` (each compared number and its limit).
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class BenchError(RuntimeError):
    """A run that cannot produce a result (no card, missing file)."""


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "gpbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    if spec is None or not path.is_file():
        raise BenchError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: Path):
    if not path.is_file():
        raise BenchError(f"missing {path}")
    return json.loads(path.read_text())


class Manifest:
    """BENCHMARK.json and the files it names, resolved for one workload."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = _read_json(self.root / "BENCHMARK.json")

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return _read_json(self.root / c["file"])
        raise BenchError(f"no config {name!r} in BENCHMARK.json")

    def metrics(self, section: str, workload: str) -> list[dict]:
        """The metrics of `section` ("end_to_end" | "per_layer") that the
        workload reports: those that list it, or list no workloads."""
        return [m for m in self.data[section]
                if workload in m.get("workloads", [workload])]


class Run:
    """The state of one run shared by the harness, the loop and the
    per-layer readers."""

    def __init__(self, root, workload: str, seed: int, seconds: float,
                 trace: bool, device: str = "cuda", t_start=None):
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.manifest = Manifest(root)
        self.workload = self.manifest.workload(workload)
        self.name = workload
        self.cfg = self.manifest.config(self.workload["config"])
        gp = self.manifest.root / "gpbench"
        self.traffic = _read_json(gp / "traffic"
                                  / f"{self.workload['traffic']}.json")
        self.limits = _read_json(gp / "limits" / f"{workload}.json")
        self.metric_dir = gp / "metrics"
        self.seed, self.seconds = int(seed), float(seconds)
        self.trace, self.device = bool(trace), device
        self.e2e: dict[str, float] = {}
        self.layer: dict = {}
        self.checks: dict[str, tuple[float, float]] = {}
        self.attempted = self.failed = 0
        self.memory_peak = 0
        self.profiler = None
        import torch  # noqa: F401
        self.mark("torch")
        self.loop = load_module(gp / "loops"
                                  / f"{self.traffic['loop']}.py")

    def mark(self, stage: str):
        """Seconds since process start at the end of a set-up stage (printed
        with the readings, for set-up's breakdown)."""
        self.layer.setdefault("setup_marks", {})[stage] = \
            time.perf_counter() - self.t_start

    def mark_setup_done(self):
        """Called by the loop just before its first timed unit."""
        self.e2e["setup_s"] = time.perf_counter() - self.t_start

    def check(self, name: str, value: float):
        """Record a compared number against the cell's limit for it."""
        if name not in self.limits:
            raise BenchError(f"limits/{self.name}.json has no limit for "
                             f"{name!r}")
        self.checks[name] = (float(value), float(self.limits[name]))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def require_chips(n: int):
    import torch
    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < n:
        raise BenchError(f"the cell asks for {n} card(s), "
                         f"{torch.cuda.device_count()} visible")


def execute(run: Run):
    """Set up, measure, read the memory peak, free the program's state and
    check its answers against the reference."""
    import torch
    lp = run.loop
    if run.trace:
        from .trace import Profiler
        run.profiler = Profiler(run.device != "cpu")
    try:
        state = lp.setup(run)
        lp.window(run, state)
    finally:
        if run.profiler is not None:
            run.profiler.stop()
    if run.device != "cpu":
        torch.cuda.synchronize()
        run.memory_peak = int(torch.cuda.max_memory_allocated())
    lp.release(run, state)
    if run.device != "cpu":
        torch.cuda.empty_cache()
    lp.check(run, state)


def per_layer(run: Run) -> dict:
    out = {}
    for m in run.manifest.metrics("per_layer", run.name):
        reader = load_module(run.metric_dir / f"{m['name']}.py")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def end_to_end(run: Run) -> dict:
    out = {}
    for m in run.manifest.metrics("end_to_end", run.name):
        if m["name"] not in run.e2e:
            raise BenchError(f"the {run.traffic['loop']} loop did not measure "
                             f"{m['name']!r}")
        out[m["name"]] = {"value": float(run.e2e[m["name"]]),
                          "unit": m["unit"]}
    return out


def result(run: Run) -> dict:
    import torch
    device = {"platform": "gpu" if run.device != "cpu" else "cpu",
              "kind": (torch.cuda.get_device_name(0) if run.device != "cpu"
                       else "cpu"),
              "count": int(run.workload["chips"]),
              "memory_peak_bytes": run.memory_peak}
    line = {"correct": run.correct, "attempted": run.attempted,
            "failed": run.failed}
    if run.trace:
        tr = run.layer["trace"]
        device["busy_s"], device["window_s"] = tr["busy_s"], tr["window_s"]
        line["metrics"] = per_layer(run)
        line["device"] = device
        from .trace import breakdown
        line["breakdown"] = breakdown(tr)
    else:
        line["metrics"] = end_to_end(run)
        line["device"] = device
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in run.checks.items()}
    return line


def card_line() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(args, t_start: float) -> int:
    run = None
    try:
        run = Run(Path(args.root), args.workload, args.seed, args.seconds,
                  args.trace, t_start=t_start)
        run.mark("program")
        require_chips(int(run.workload["chips"]))
        run.mark("cuda")
        execute(run)
    except BenchError as e:
        print(f"gpbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"gpbench: the run loaded {found}: the benchmark measures the "
              f"PyTorch port alone", file=sys.stderr)
        return 3
    line = result(run)
    print(f"gpbench: card {card_line()}", file=sys.stderr)
    print("gpbench: readings " + json.dumps(
        {k: v for k, v in run.layer.items() if k != "trace"}),
        file=sys.stderr)
    for k, (v, lim) in run.checks.items():
        print(f"check {k} {v!r} limit {lim!r} "
              f"{'ok' if math.isfinite(v) and v <= lim else 'FAIL'}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
