"""Tiny cells for the harness's CPU tests: a copy of the benchmark in a
temporary directory with small configurations, traffic mixes and limits
added as new files and manifest entries, the way a later change adds a
cell. The program beside it is the repository's own `src/`."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for _p in (str(REPO / "src"), str(REPO)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
TINY = {"n_train": 4 * 96, "rff_features": 256}
TRAFFIC = {
    "tiny-serve": {"loop": "closed_loop", "clients": 3, "rows_min": 4,
                   "rows_max": 80, "size_pool": 16, "max_requests_per_s": 200,
                   "max_slot": 64, "max_wait_ms": 1.0, "check_requests": 6,
                   "think_ms_max": 5.0, "check_slots": 4,
                   "trace_after_s": 0.2, "trace_seconds": 0.3},
    "tiny-train": {"loop": "fit_loop", "iters_per_fit": 3,
                   "trace_after_s": 0.0, "trace_seconds": 0.01},
    "tiny-stream": {"loop": "stream", "query_every": 2, "query_rows": 24,
                    "warm_rounds": 2, "max_rounds_per_s": 400,
                    "check_batches": 2, "trace_after_s": 0.1,
                    "trace_seconds": 0.2},
}
# limits of the tiny cells, set between the float32 program's readings
# against the float64 reference at these sizes on the CPU (seeds 1-6: serve
# mean 3.6e-4, var 9.8e-6, dac 1.8e-7; train theta 1.1e-7, change 5.6e-7,
# first residual 1.7e-5; stream mean 3.4e-4, var 1.1e-5, dac 6.3e-8) and
# the TF32 control's (serve 2.7e-2, 2.2e-4, 1.6e-5; train 7.9e-7, 2.1e-5,
# 2.7e-4; stream 1.5e-2, 1.2e-4, 1.3e-5)
LIMITS = {
    "tiny.serve": {"failed_requests": 0, "bad_answers": 0, "mean_err": 3e-3,
                   "var_err": 5e-5, "dac_err": 2e-6},
    "tiny.train": {"failed_fits": 0, "theta_gap": 3e-7, "change_gap": 5e-6,
                   "first_residual_gap": 1e-4},
    "tiny-window.stream": {"bad_answers": 0, "mean_err": 3e-3,
                           "var_err": 5e-5, "dac_err": 2e-6, "window_err": 0},
}


def tiny_config(name: str, base: str) -> dict:
    cfg = json.loads((REPO / "gpbench" / "configs" / f"{base}.json")
                     .read_text())
    cfg.update(TINY, name=name, chunk=32, dac_iters=50)
    if cfg.get("online"):
        cfg["window"] = TINY["n_train"] // cfg["num_agents"]
    return cfg


def make_copy(dest: Path) -> Path:
    """Copy BENCHMARK.json and gpbench/ to `dest`, add the tiny cells by
    new files and manifest entries only, and link the program's sources.
    Returns dest."""
    dest = Path(dest)
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "gpbench", dest / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dest / "src").symlink_to(REPO / "src")
    gp = dest / "gpbench"
    manifest = json.loads((dest / "BENCHMARK.json").read_text())
    for name, base in (("tiny", "paper-m4"),
                       ("tiny-window", "paper-m4-window")):
        (gp / "configs" / f"{name}.json").write_text(
            json.dumps(tiny_config(name, base)))
        manifest["configs"].append(
            {"name": name, "source": "https://arxiv.org/abs/2203.02865",
             "file": f"gpbench/configs/{name}.json",
             "reduced": ["n_train"], "why": "the harness's CPU tests"})
    for name, traffic in TRAFFIC.items():
        (gp / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    for cell, limits in LIMITS.items():
        (gp / "limits" / f"{cell}.json").write_text(json.dumps(limits))
        config, kind = cell.split(".")
        manifest["workloads"].append(
            {"name": cell, "config": config, "traffic": f"tiny-{kind}",
             "chips": 1, "why": "the harness's CPU tests"})
    by_kind = {"serve": "paper-m4.serve", "train": "paper-m4.train",
               "stream": "paper-m4-window.stream"}
    for section in ("end_to_end", "per_layer"):
        for m in manifest[section]:
            for cell in LIMITS:
                if by_kind[cell.split(".")[1]] in m.get("workloads", []):
                    m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest))
    return dest


def run_cell(root: Path, workload: str, seed: int = 3, seconds: float = 1.0,
             trace: bool = False):
    """Drive one run of a cell on the CPU: everything but the look for a
    card. Returns (run, result line)."""
    from gpbench import harness
    run = harness.Run(root, workload, seed, seconds, trace, device="cpu")
    harness.execute(run)
    return run, harness.result(run)
