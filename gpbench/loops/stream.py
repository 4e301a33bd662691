"""A streaming fleet: rounds of one new observation per agent into full
sliding windows (`GPFleet.observe`: the oldest point evicted through the
rank-1 `cholupdate`, the new one appended), with a `query_rows` rBCM batch
(`GPFleet.predict`) after every `query_every`-th round, its answer copied
to the host. Set-up fills each window with its agent's stripe and runs
`warm_rounds` rounds of the same stream.

End-to-end (host clock): obs_per_s, the observations of the window's
rounds over its seconds, the query batches' time included.

`correct`: a sample of the served batches, drawn from the seed and with
the last (served from the windows' final factors: the window ends on a
served round), against the float64 reference's rBCM answers on the
windows as they stood, rebuilt from the inputs and factored anew, and
those batches' consensus residuals (the engine's report of how far its
agents' DAC estimates still differ) against the reference's; every answer
finite with a positive variance; the windows' contents after the last
round exactly the reference's (which points, in which slot).
"""
from __future__ import annotations

import random
import time

import torch

from gpbench import compare, data, program
from gpbench.reference import gp as ref
from gpbench.trace import Timed, label


class State:
    pass


def inputs(run, device):
    cfg, tr = run.cfg, run.traffic
    Xp, yp, field, gen = data.fleet_data(cfg, run.seed, device)
    rounds = tr["warm_rounds"] + int(tr["max_rounds_per_s"] * run.seconds)
    xs, ys = data.stream_observations(cfg, field, gen, Xp, rounds)
    Xq = data.queries(cfg, gen, (rounds // tr["query_every"] + 1)
                      * tr["query_rows"], device)
    return Xp, yp, xs, ys, Xq


def setup(run):
    cfg, tr = run.cfg, run.traffic
    dev = torch.device(run.device)
    st = State()
    st.Xp, st.yp, st.xs, st.ys, st.Xq = inputs(run, dev)
    run.mark("data")
    st.fleet = program.fleet(cfg, dev).fit(
        st.Xp, st.yp, log_theta0=program.log_theta(cfg["true_theta"], dev),
        train=False)
    run.mark("fit")
    st.r = st.b = 0
    st.answers = []          # (rounds before it, mean, var, dac_residual)
    for _ in range(tr["warm_rounds"]):
        _round(run, st)
    run.mark("warm_rounds")
    if run.device != "cpu":
        torch.cuda.synchronize()
    return st


def _round(run, st):
    tr = run.traffic
    with label("observe"):
        st.fleet.observe(st.xs[st.r], st.ys[st.r])
    st.r += 1
    if st.r % tr["query_every"] == 0:
        n = tr["query_rows"]
        with label("predict"):
            m, v, info = st.fleet.predict(st.Xq[st.b * n:(st.b + 1) * n])
            st.answers.append((st.r, m.cpu(), v.cpu(),
                               info.get("dac_residual")))
        st.b += 1


def window(run, st):
    tr = run.traffic
    timed = Timed(run, tr["trace_after_s"], tr["trace_seconds"])
    r0, b0 = st.r, st.b
    run.mark_setup_done()
    t0 = time.perf_counter()
    limit = st.xs.shape[0]
    q = tr["query_every"]
    while st.r < limit and (st.r % q or
                            (elapsed := time.perf_counter() - t0)
                            < run.seconds):
        if st.r % q == 0:
            timed.poll(elapsed)
        _round(run, st)
    if run.device != "cpu":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    timed.close()
    M, W, D = st.Xp.shape
    rounds, batches = st.r - r0, st.b - b0
    run.attempted = rounds + batches
    run.e2e["obs_per_s"] = rounds * M / elapsed
    run.layer.update(rounds=rounds, batches=batches, window_s=elapsed,
                     shape=(M, W, D), query_rows=tr["query_rows"],
                     chunk=run.cfg["chunk"])
    if run.trace:
        run.layer["trace"] = timed.summary()
    f = st.fleet.fitted              # the windows as the engine serves them
    st.window = (f.Xp, f.yp, st.fleet.window_counts)


def release(run, st):
    del st.fleet


def windows_at(st, r: int):
    """Every agent's window after `r` rounds of the stream, oldest first."""
    W = st.Xp.shape[1]
    parts = [ref.window(st.Xp[i], st.yp[i], st.xs[:r, i], st.ys[:r, i], W)
             for i in range(st.Xp.shape[0])]
    return (torch.stack([p[0] for p in parts]),
            torch.stack([p[1] for p in parts]))


def sample(run, st) -> list[int]:
    rng = random.Random(run.seed)
    idx = list(range(len(st.answers)))
    pick = set(rng.sample(idx, min(run.traffic["check_batches"], len(idx))))
    pick.add(len(idx) - 1)
    return sorted(pick)


def reference_fleet(run, Xw, yw, prec):
    cfg = run.cfg
    dt = ref.dtype_of(prec)
    theta = torch.tensor(cfg["true_theta"], dtype=dt, device=Xw.device)
    return ref.Fleet(Xw.to(dt), yw.to(dt), theta, cfg["jitter"], prec)


def batch_errors(run, st, pick, prec):
    n, sf = run.traffic["query_rows"], run.cfg["true_theta"][
        run.cfg["input_dim"]]
    errs = []
    for j in pick:
        r, m, v, residual = st.answers[j]
        fleet = reference_fleet(run, *windows_at(st, r), prec)
        m_ref, v_ref, res_ref = fleet.predict(
            st.Xq[j * n:(j + 1) * n], data.graph(run.cfg),
            run.cfg["dac_iters"])
        del fleet
        errs.append(compare.answer_errors(m, v, m_ref, v_ref, sf))
        errs[-1]["dac_err"] = (
            float("inf") if residual is None
            else compare.dac_error(residual, m, v, res_ref, m_ref, v_ref))
    return errs


def window_error(st) -> float:
    """Largest difference between the program's windows (inputs, targets,
    counts) after the last round and the reference's: 0 when every agent
    holds the right points in the right slots."""
    Xw, yw, count = st.window
    Xr, yr = windows_at(st, st.r)
    if Xw.shape != Xr.shape:
        return float("inf")
    return max(float((Xw - Xr).abs().max()), float((yw - yr).abs().max()),
               float((count - Xr.shape[1]).abs().max()))


def check(run, st):
    run.check("bad_answers", sum(compare.bad_answers(m, v)
                                 for _, m, v, _ in st.answers))
    errs = batch_errors(run, st, sample(run, st), "float64")
    run.check("mean_err", compare.worst(errs, "mean_err"))
    run.check("var_err", compare.worst(errs, "var_err"))
    run.check("dac_err", compare.worst(errs, "dac_err"))
    run.check("window_err", window_error(st))
