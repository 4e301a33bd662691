#!/usr/bin/env python3
"""Time builds of the rbf_matvec kernel against each other on one card.

    python3 tools/rbf_matvec_compare.py --tree old=PATH --tree new=. \\
        --order old,new,new,old [--out FILE]

Each TREE is the root of a checkout of this repository (its `src/` holds a
`repro_torch`). The trees run one after another in the given order, each
in its own process (two builds of one package cannot share a process),
all on the same card, and each prints one JSON line:

  * per shape (the serving tile 256 x 4 x 8,100, the sparse tile
    256 x 4 x 512, the paper's largest fleet 256 x 40 x 810; D = 2): the
    wrapper's device time a call and device operations a call from a
    torch.profiler trace of 50 back-to-back calls, ms a call by CUDA
    events over 200 back-to-back calls, the host's us a call (the enqueue
    of 200 calls), max error relative to the summed |terms| of the float64
    plain version, and whether 20 calls are bitwise equal;
  * one served 256-query rBCM batch of a 4 x 8,100-point fleet (float32,
    streamed mean), traced: device operations, the kernel's device time
    and launches, the device's busy time;
  * `stream_means` alone on the same fleet and queries, traced: its device
    operations;
  * end to end, on the host's clock with a synchronize after each: the
    median and quartiles of BATCHES served 256-query rBCM batches of that
    fleet, and of a sparse fleet of the same points (m = 512 inducing
    points, float64 data, as chip_smoke.py's sparse phase serves it).

A tree whose wrapper takes (a, b, v, sf2) gets its inputs scaled by
1/lengthscale outside the timed calls; one that takes (a, b, v, ls, sf2)
gets them as they are. The card's name and power limit head the output.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(256, 4, 8100, 2), (256, 4, 512, 2), (256, 40, 810, 2)]
LS, SF = (1.2, 0.3), 1.3
TRACED, EVENTS, REPEATS, BATCHES = 50, 200, 20, 20


def worker(src: str) -> dict:
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import torch
    from chip_smoke import _profiled, cuda_ms
    from repro_torch.core.gp import pack
    from repro_torch.core.prediction.local import stream_means
    from repro_torch.fleet import FleetConfig, GPFleet
    from repro_torch.kernels import rbf_matvec as K
    dev = torch.device("cuda")
    old_api = len(inspect.signature(K.rbf_matvec).parameters) == 4
    gen = torch.Generator(dev).manual_seed(0)
    ls = torch.tensor(LS, device=dev)
    sf2 = torch.tensor([SF ** 2], device=dev)
    out = {"src": src, "wrapper_args": "a, b, v, sf2" if old_api
           else "a, b, v, ls, sf2", "shapes": []}
    for Nt, M, Ni, D in SHAPES:
        a = 2 * torch.rand(Nt, D, generator=gen, device=dev)
        b = 2 * torch.rand(M, Ni, D, generator=gen, device=dev)
        v = torch.randn(M, Ni, generator=gen, device=dev)
        args = ((a / ls).contiguous(), (b / ls).contiguous(), v, sf2) \
            if old_api else (a, b, v, ls, sf2)

        def call():
            return K.rbf_matvec(*args)
        first = call()
        want = K.rbf_matvec_plain(*(t.double() for t in args))
        scale = K.rbf_matvec_plain(*(t.double().abs() if t is v
                                     else t.double() for t in args))
        trace = _profiled(lambda: [call() for _ in range(TRACED)],
                          "rbf_matvec")
        row = {"Nt": Nt, "M": M, "Ni": Ni, "D": D,
               "device_ms": trace["rbf_matvec_device_ms"] / TRACED,
               "device_ops_per_call": trace["kernels_launched"] / TRACED,
               "ms": cuda_ms(call, EVENTS),
               "max_rel_err": float(((first.double() - want).abs()
                                     / scale).max()),
               "bitwise_repeatable": all(torch.equal(call(), first)
                                         for _ in range(REPEATS))}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EVENTS):
            call()
        row["host_us_per_call"] = 1e6 * (time.perf_counter() - t0) / EVENTS
        torch.cuda.synchronize()
        out["shapes"].append(row)

    lt = pack(list(LS), SF, 0.1, dtype=torch.float32, device=dev)
    X = 2 * torch.rand(4 * 8100, 2, generator=gen, device=dev)
    X = X[torch.argsort(X[:, 0])]
    y = torch.sin(2 * X[:, 0]) * torch.cos(3 * X[:, 1]) \
        + 0.1 * torch.randn(X.shape[0], generator=gen, device=dev)
    fleet = GPFleet(FleetConfig(stream_mean=True), device="cuda").fit(
        X.reshape(4, 8100, 2), y.reshape(4, 8100), log_theta0=lt,
        train=False)
    Xq = 2 * torch.rand(256, 2, generator=gen, device=dev)
    trace = _profiled(lambda: fleet.predict(Xq), "rbf_matvec")
    out["serve_batch"] = {k: trace[k] for k in (
        "wall_ms", "device_busy_ms", "kernels_launched",
        "rbf_matvec_device_ms", "rbf_matvec_device_launches")}
    f = fleet.fitted
    trace = _profiled(lambda: stream_means(f.log_theta, f.Xp, f.alpha, Xq),
                      "rbf_matvec")
    out["stream_means"] = {
        "device_ops": trace["kernels_launched"],
        "ops": [(k["name"][:60], k["count"]) for k in trace["top_kernels"]]}
    sparse = GPFleet(FleetConfig(sparse_m=512, stream_mean=True),
                     device="cuda").fit(X.reshape(4, 8100, 2).double(),
                                        y.reshape(4, 8100).double(),
                                        log_theta0=lt.double(), train=False)
    for name, fl, q in (("serve_batch_ms", fleet, Xq),
                        ("sparse_batch_ms", sparse, Xq.double())):
        fl.predict(q)
        torch.cuda.synchronize()
        ms = []
        for _ in range(BATCHES):
            t0 = time.perf_counter()
            fl.predict(q)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        q1, med, q3 = statistics.quantiles(ms, n=4)
        out[name] = {"median": med, "q1": q1, "q3": q3}
    return out


def run_trees(script: str, worker_fn, doc: str, argv=None) -> int:
    """The command line of the compare tools: `--tree NAME=PATH` checkouts
    run in `--order`, each in its own process (`script --worker SRC`,
    whose last line is `worker_fn(SRC)` as JSON), the card's name and
    power limit first, every line also appended to `--out`."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=PATH of a checkout to time")
    ap.add_argument("--order", help="comma-separated NAMEs, run in turn")
    ap.add_argument("--out", help="also append the lines to this file")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker_fn(args.worker)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print(f"{Path(script).stem}: no CUDA device", file=sys.stderr)
        return 1
    trees = dict(t.split("=", 1) for t in args.tree)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lines = [json.dumps({"card": card})]
    print(lines[0], flush=True)
    rc = 0
    for name in args.order.split(","):
        src = str((Path(trees[name]) / "src").resolve())
        proc = subprocess.run([sys.executable, script, "--worker", src],
                              capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": ""})
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            rc = 1
            continue
        line = json.dumps({"tree": name,
                           **json.loads(proc.stdout.splitlines()[-1])})
        lines.append(line)
        print(line, flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write("\n".join(lines) + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(run_trees(__file__, worker, __doc__))
