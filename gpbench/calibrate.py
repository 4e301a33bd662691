"""Upper readings of the numbers that decide `correct`, at a cell's own
size on the card: the control (the plain reference put in the program's
place and computed one precision below the configuration's float32, in
TF32) and, for the training and streaming cells, the program with a fault
planted. The lower readings are the benchmark's own runs (each prints its
numbers beside their limits). The harness's runs never run this.

    python3 gpbench/calibrate.py --workload paper-m4.train --seeds 11,12,13

prints one JSON line per seed and reading: {"workload", "seed", "kind",
"numbers"}. `kind` is "control" or "fault:<name>":

  serve   control: the TF32 reference's answers and consensus residual on
          the rows a run checks; fault:no_exchange, the program's engine
          with no edge in its DAC sweeps, on a slot of those rows.
  train   control: the TF32 reference's DEC-apx-GP; fault:half_batch, the
          program's fit on every other point of each agent (the gradient's
          mean over the rest); fault:no_exchange, the program's fit with no
          neighbour in the ADMM sums; fault:unchanged, a fit that returns
          theta0 (no run: read from theta0).
  stream  control: the TF32 reference's factors, answers and consensus
          residual on the windows a run checks; fault:unchanged, the
          program's stream with every observe returning its state
          unchanged; fault:no_exchange, the program's stream with no edge
          in its DAC sweeps.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def serve_readings(run):
    import torch
    from gpbench import compare, program
    lp, cfg = run.loop, run.cfg
    dev = torch.device(run.device)
    Xp, yp, offsets, rows, _ = lp.inputs(run, dev)
    n = run.traffic["check_requests"]
    pool = run.traffic["size_pool"]
    sizes = [int(offsets[k + 1] - offsets[k]) for k in range(pool)]
    # as many requests as a run checks, with the largest size among them
    ks = sorted(set(range(n)) | {max(range(pool), key=lambda k: sizes[k])})
    Xs = torch.cat([rows[offsets[k]:offsets[k + 1]] for k in ks])
    slot = Xs[:run.traffic["max_slot"]]
    f64 = lp.reference_fleet(run, Xp, yp, "float64")
    m64, v64, _ = lp.reference_answers(f64, run, Xs)
    slot64 = lp.reference_answers(f64, run, slot)
    del f64
    ftf = lp.reference_fleet(run, Xp, yp, "tf32")
    m32, v32, _ = lp.reference_answers(ftf, run, Xs)
    slot32 = lp.reference_answers(ftf, run, slot)
    del ftf
    sf = cfg["true_theta"][cfg["input_dim"]]
    numbers = compare.answer_errors(m32.cpu(), v32.cpu(), m64, v64, sf)
    numbers["dac_err"] = _dac_err(slot32, slot64)
    yield "control", numbers
    # the program's engine with no exchange between its agents, on a slot
    fleet = program.fleet(cfg, dev).fit(
        Xp, yp, log_theta0=program.log_theta(cfg["true_theta"], dev),
        train=False)
    with program.no_exchange():
        m, v, info = fleet.predict(slot)
    del fleet
    numbers = compare.answer_errors(m.cpu(), v.cpu(), slot64[0], slot64[1],
                                    sf)
    numbers["dac_err"] = _dac_err((m, v, info["dac_residual"]), slot64)
    yield "fault:no_exchange", numbers


def _dac_err(got, ref):
    """compare.dac_error of answers (mean, var, residual) against the
    reference's."""
    from gpbench import compare
    return compare.dac_error(got[2], got[0], got[1], ref[2], ref[0], ref[1])


def train_readings(run):
    import torch
    from gpbench import compare, data, program
    lp, cfg = run.loop, run.cfg
    dev = torch.device(run.device)
    Xp, yp, _, _ = data.fleet_data(cfg, run.seed, dev)
    th64, r64 = lp.reference_fit(run, Xp, yp, "float64")
    lt0 = torch.log(torch.tensor(cfg["theta0"], dtype=torch.float64))
    yield "fault:unchanged", compare.theta_gaps(
        lt0.expand_as(th64), torch.zeros_like(r64), th64, r64, lt0)
    thc, rc = lp.reference_fit(run, Xp, yp, "tf32")
    yield "control", compare.theta_gaps(thc, rc, th64, r64, lt0)
    iters = run.traffic["iters_per_fit"]
    for name, A, X, y in (
            ("half_batch", None, Xp[:, ::2].contiguous(),
             yp[:, ::2].contiguous()),
            ("no_exchange", torch.zeros(cfg["num_agents"], cfg["num_agents"],
                                        dtype=torch.float64), Xp, yp)):
        fleet = program.fleet(cfg, dev, A=A, admm_iters=iters)
        fleet.fit(X, y, train=True)
        yield f"fault:{name}", compare.theta_gaps(
            fleet.thetas, fleet.train_info["residuals"], th64, r64, lt0)
        del fleet
        if run.device != "cpu":
            torch.cuda.empty_cache()


def stream_readings(run, fault_seconds: float):
    import torch
    from gpbench import compare, program
    lp = run.loop
    dev = torch.device(run.device)
    st = lp.State()
    st.Xp, st.yp, st.xs, st.ys, st.Xq = lp.inputs(run, dev)
    tr = run.traffic
    rounds = 64 * tr["query_every"]
    n = tr["query_rows"]
    sf = run.cfg["true_theta"][run.cfg["input_dim"]]
    Xw, yw = lp.windows_at(st, rounds)
    f64 = lp.reference_fleet(run, Xw, yw, "float64")
    ftf = lp.reference_fleet(run, Xw, yw, "tf32")
    Xq = st.Xq[:n]
    a64 = f64.predict(Xq, _graph(run), run.cfg["dac_iters"])
    atf = ftf.predict(Xq, _graph(run), run.cfg["dac_iters"])
    numbers = compare.answer_errors(atf[0].cpu(), atf[1].cpu(), a64[0],
                                    a64[1], sf)
    numbers["dac_err"] = _dac_err(atf, a64)
    # the control holds the reference's windows: its window_err is 0
    numbers["factor_err"] = compare.factor_error(
        [p[1] for p in ftf.parts], [p[1] for p in f64.parts])
    del f64, ftf
    yield "control", numbers
    # the program's own stream with observe returning its state unchanged,
    # then with no edge in its DAC sweeps
    observe = program.GPFleet.observe
    program.GPFleet.observe = lambda self, xs, ys: self
    try:
        yield "fault:unchanged", _fault_run(run, fault_seconds)
    finally:
        program.GPFleet.observe = observe
    with program.no_exchange():
        yield "fault:no_exchange", _fault_run(run, fault_seconds)


def _fault_run(run, seconds):
    """The cell's numbers from a run of `seconds` with a fault planted."""
    from gpbench import harness
    frun = harness.Run(run.manifest.root, run.name, run.seed, seconds,
                       False, device=run.device)
    harness.execute(frun)
    return {k: v for k, (v, _) in frun.checks.items()}


def _graph(run):
    from gpbench import data
    return data.graph(run.cfg)


def readings(run, fault_seconds: float):
    """(kind, numbers) of the cell's control and planted faults."""
    kind = run.traffic["loop"]
    if kind == "closed_loop":
        return serve_readings(run)
    if kind == "fit_loop":
        return train_readings(run)
    if kind == "stream":
        return stream_readings(run, fault_seconds)
    raise ValueError(f"no readings for the {kind!r} loop")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault-seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from gpbench import harness
    harness.require_chips(1)
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(ROOT, args.workload, seed, args.fault_seconds,
                          False)
        t0 = time.perf_counter()
        for what, numbers in readings(run, args.fault_seconds):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": what, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            t0 = time.perf_counter()


if __name__ == "__main__":
    main()
