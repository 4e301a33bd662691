"""Every loop run end to end on the CPU at tiny size, in a copy of the
benchmark to which the tiny cells, a traffic mix of each kind and a new
per-layer metric were added as new files and manifest entries alone; the
timed path broken underneath makes `correct` false; the control reads
above the limits."""
import json
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parents[1]), str(HERE)]

import gpbench_tiny as T  # noqa: E402
from gpbench import program  # noqa: E402

CELLS = ("tiny.serve", "tiny.train", "tiny-window.stream")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = T.make_copy(tmp_path_factory.mktemp("bench"))
    # a per-layer metric added as one reader file and one manifest entry
    (root / "gpbench" / "metrics" / "answered_rows.serve.py").write_text(
        "def read(run):\n"
        "    return run.layer.get('answered_rows')\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["per_layer"].append(
        {"name": "answered_rows.serve", "unit": "rows", "better": "higher",
         "source": "program_counter", "layer": "front door",
         "moves": "queries_per_s", "workloads": ["tiny.serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(root, cell):
    run, line = T.run_cell(root, cell, seconds=0.8)
    assert line["correct"] is True, line["checks"]
    assert run.attempted > 0 and line["failed"] == 0
    e2e = [m["name"] for m in run.manifest.metrics("end_to_end", cell)]
    assert "setup_s" in e2e and sorted(line["metrics"]) == sorted(e2e)
    assert list(line)[-1] == "checks"


def test_traced_run_reports_the_added_metric(root):
    run, line = T.run_cell(root, "tiny.serve", seconds=0.8, trace=True)
    metrics = line["metrics"]
    assert metrics["answered_rows.serve"]["value"] == \
        run.layer["answered_rows"] > 0
    assert 0 <= metrics["queue_share.serve"]["value"] <= 100
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert "queries_per_s" not in metrics


def _patched(monkeypatch, name, fn):
    from repro_torch.fleet import GPFleet
    orig = getattr(GPFleet, name)
    monkeypatch.setattr(GPFleet, name,
                        lambda self, *a, **k: fn(orig, self, *a, **k))


def _altered(orig, self, Xs, *a, **k):
    """An answer altered where it is produced: one mean moved by 1e-2."""
    mean, var, info = orig(self, Xs, *a, **k)
    mean = mean.clone()
    mean[0] += 1e-2
    return mean, var, info


def _half_answered(orig, self, Xs, *a, **k):
    """Half of the batch left out, its answers the mean over the rest."""
    n = Xs.shape[0]
    h = max(n // 2, 1)
    mean, var, info = orig(self, Xs[:h], *a, **k)
    return (torch.cat([mean, mean.mean().expand(n - h)]),
            torch.cat([var, var.mean().expand(n - h)]), info)


def _unchanged_fit(orig, self, Xp, yp, *a, **k):
    """A fit whose steps return their state unchanged: theta0 back."""
    orig(self, Xp, yp, *a, **k)
    if k.get("train", True):
        lt0 = torch.log(torch.tensor(self.config.theta0, dtype=Xp.dtype))
        self.thetas = lt0.expand_as(self.thetas).clone()
        self.train_info = {"residuals": torch.zeros_like(
            self.train_info["residuals"])}
    return self


def _half_fit(orig, self, Xp, yp, *a, **k):
    """Half of each agent's points left out of the gradient."""
    if k.get("train", True):
        return orig(self, Xp[:, ::2].contiguous(), yp[:, ::2].contiguous(),
                    *a, **k)
    return orig(self, Xp, yp, *a, **k)


def _no_exchange_fit(orig, self, Xp, yp, *a, **k):
    """The exchange between agents left out: no neighbour in the ADMM."""
    A = self.A
    self.A = torch.zeros_like(A)
    try:
        return orig(self, Xp, yp, *a, **k)
    finally:
        self.A = A


FAULTS = [("tiny.serve", "predict", _altered),
          ("tiny.serve", "predict", _half_answered),
          ("tiny.serve", None, program.no_exchange),
          ("tiny.train", "fit", _unchanged_fit),
          ("tiny.train", "fit", _half_fit),
          ("tiny.train", "fit", _no_exchange_fit),
          ("tiny-window.stream", "observe", lambda orig, self, *a: self),
          ("tiny-window.stream", "predict", _altered),
          ("tiny-window.stream", None, program.no_exchange)]


@pytest.mark.parametrize("cell,method,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, _, f in FAULTS])
def test_broken_timed_path_is_not_correct(root, monkeypatch, cell, method,
                                          fault):
    if method is None:
        # the exchange between agents left out: only the agents'
        # disagreement shows it, the mean over them being unchanged
        with fault():
            _, line = T.run_cell(root, cell, seconds=0.5)
        checks = line["checks"]
        assert checks["dac_err"]["value"] > checks["dac_err"]["limit"]
        assert checks["mean_err"]["value"] <= checks["mean_err"]["limit"]
    else:
        _patched(monkeypatch, method, fault)
        _, line = T.run_cell(root, cell, seconds=0.5)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_a_limit(root, cell):
    """The plain reference in TF32, put in the program's place, fails at
    least one of the cell's numbers (the tiny cells' limits)."""
    from gpbench import calibrate, harness
    run = harness.Run(root, cell, 5, 0.5, False, device="cpu")
    control = dict(calibrate.readings(run, 0.5))["control"]
    assert any(v > run.limits[k] for k, v in control.items()), control
