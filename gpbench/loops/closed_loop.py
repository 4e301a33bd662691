"""Closed-loop serving through the front door (`GPFleet.to_server`).

`clients` clients each keep one request in flight: a ragged batch of
query rows, its rows uniform over the field's domain and never repeated,
its size from blocks of `size_pool` sizes evenly spread over [rows_min,
rows_max], each block in an order drawn from the run's seed (every seed
serves the same sizes, in another order). A client sends its next request
a think time after the answer (mean, var) of the last has reached the
host, uniform on [0, think_ms_max] and drawn from the seed: the robot
moves before it asks again. Without it every request would be sent the
moment a slot finished, its latency a whole number of slot times, and the
95th percentile would jump a whole slot between seeds.

End-to-end (host clock): queries_per_s, the rows of the requests answered
within the window over its seconds; request_p95_ms, the 95th percentile of
those requests' times from submission to answer.

`correct`: a sample of the answered requests, drawn from the seed and with
the largest among them, against the float64 reference's rBCM answers on
the same rows; a sample of the slots the front door dispatched, drawn from
the seed, whose consensus residual (the engine's report of how far its
agents' DAC estimates still differ) is held against the reference's on the
slot's rows; every answer finite with a positive variance; no request
failed.
"""
from __future__ import annotations

import heapq
import queue
import random
import time

import numpy as np
import torch

from gpbench import compare, data, program
from gpbench.reference import gp as ref
from gpbench.trace import Timed

STAGES = ("queue", "pack", "dispatch", "device", "stitch")


class State:
    pass


def inputs(run, device):
    """Fleet data, every request's rows and the clients' think times, from
    the seed."""
    cfg, tr = run.cfg, run.traffic
    Xp, yp, _, gen = data.fleet_data(cfg, run.seed, device)
    n_req = max(tr["size_pool"], int(tr["max_requests_per_s"] * run.seconds))
    sizes = data.request_sizes(tr["rows_min"], tr["rows_max"],
                               tr["size_pool"], n_req, run.seed)
    offsets = np.cumsum([0] + sizes)
    rows = data.queries(cfg, gen, int(offsets[-1]), device)
    think = data.think_times(1e-3 * tr["think_ms_max"], n_req, run.seed)
    return Xp, yp, offsets, rows, think


def setup(run):
    cfg, tr = run.cfg, run.traffic
    dev = torch.device(run.device)
    st = State()
    st.Xp, st.yp, st.offsets, rows, st.think = inputs(run, dev)
    st.rows = rows.cpu().numpy()
    run.mark("data")
    st.fleet = program.fleet(cfg, dev).fit(
        st.Xp, st.yp, log_theta0=program.log_theta(cfg["true_theta"], dev),
        train=False)
    run.mark("fit")
    st.srv = st.fleet.to_server(
        batch=tr["max_slot"], max_wait_ms=tr["max_wait_ms"],
        queue_depth=tr["clients"] * tr["rows_max"])
    st.slots = []           # (rows, dac_residual, mean, var) a dispatch
    program.record_slots(st.srv, st.slots)
    run.mark("warm_slots")
    st.stages = program.default_registry().histogram(
        "gp_request_stage_seconds")
    return st


def _request(st, k):
    k %= len(st.offsets) - 1
    return st.rows[st.offsets[k]:st.offsets[k + 1]]


def _think(st, k):
    return st.think[k % len(st.think)]


def _counters(st):
    s = st.srv.stats
    return ({x: st.stages.sum(tenant="default", stage=x) for x in STAGES},
            s.queries, s.padded_queries)


def window(run, st):
    tr = run.traffic
    done = queue.SimpleQueue()
    st.submitted = {}                 # k -> (client, t_submit)
    st.answers = {}                   # k -> (mean, var), answered in time
    due = []                          # (t_send, client) after a think time
    latencies, rows = [], 0
    nxt = 0

    def submit(client):
        nonlocal nxt
        k, nxt = nxt, nxt + 1
        st.submitted[k] = (client, time.perf_counter())
        fut = st.srv.submit(_request(st, k))
        fut.add_done_callback(
            lambda f, k=k: done.put((k, time.perf_counter(), f)))

    timed = Timed(run, tr["trace_after_s"], tr["trace_seconds"])
    before = _counters(st)
    run.mark_setup_done()
    t0 = time.perf_counter()
    end = t0 + run.seconds
    for c in range(tr["clients"]):
        submit(c)
    while (now := time.perf_counter()) < end:
        while due and due[0][0] <= now:
            submit(heapq.heappop(due)[1])
        wait = min(end - now, timed.poll(now - t0),
                   due[0][0] - now if due else end - now)
        try:
            k, t_done, fut = done.get(timeout=max(wait, 1e-4))
        except queue.Empty:
            continue
        client, t_sub = st.submitted.pop(k)
        if t_done <= end:
            if fut.exception() is None:
                st.answers[k] = fut.result()
                latencies.append(t_done - t_sub)
                rows += st.answers[k][0].shape[0]
            else:
                run.failed += 1
        heapq.heappush(due, (t_done + _think(st, k), client))
    after = _counters(st)
    timed.close()
    run.attempted = nxt
    # requests still in flight are waited for; they fail the run only if
    # they never come or raise
    deadline = time.perf_counter() + 60.0
    while st.submitted and time.perf_counter() < deadline:
        try:
            k, _, fut = done.get(timeout=1.0)
        except queue.Empty:
            continue
        st.submitted.pop(k, None)
        if fut.exception() is not None:
            run.failed += 1
    run.failed += len(st.submitted)

    lat = np.asarray(latencies)
    run.e2e["queries_per_s"] = rows / run.seconds
    run.e2e["request_p95_ms"] = 1e3 * float(np.percentile(lat, 95)) \
        if lat.size else float("inf")
    M, Ni, D = st.Xp.shape
    run.layer.update(
        stages_s={x: after[0][x] - before[0][x] for x in STAGES},
        rows=after[1] - before[1], padded_rows=after[2] - before[2],
        answered_rows=rows, window_s=run.seconds, shape=(M, Ni, D),
        chunk=run.cfg["chunk"])
    if run.trace:
        run.layer["trace"] = timed.summary()


def release(run, st):
    st.srv.close(drain=True, timeout=60.0)
    del st.srv, st.fleet


def sample(run, answered: list[int], sizes) -> list[int]:
    """`check_requests` answered requests drawn from the seed, with the
    largest answered request among them."""
    rng = random.Random(run.seed)
    pick = set(rng.sample(answered, min(run.traffic["check_requests"],
                                        len(answered))))
    if answered:
        pick.add(max(answered, key=lambda k: (sizes(k), -k)))
    return sorted(pick)


def reference_fleet(run, Xp, yp, prec):
    cfg = run.cfg
    dt = ref.dtype_of(prec)
    theta = torch.tensor(cfg["true_theta"], dtype=dt, device=Xp.device)
    return ref.Fleet(Xp.to(dt), yp.to(dt), theta, cfg["jitter"], prec)


def reference_answers(fleet, run, Xs):
    """The reference fleet's (mean, var, consensus residual) at Xs."""
    return fleet.predict(Xs, data.graph(run.cfg), run.cfg["dac_iters"])


def dac_errors(run, st, fleet) -> float:
    """The worst `compare.dac_error` over `check_slots` dispatched slots
    drawn from the seed, the largest slot among them."""
    slots = st.slots
    if not slots:
        return float("inf")
    rng = random.Random(run.seed + 1)
    pick = set(rng.sample(range(len(slots)),
                          min(run.traffic["check_slots"], len(slots))))
    pick.add(max(range(len(slots)), key=lambda j: slots[j][0].shape[0]))
    worst = 0.0
    for j in sorted(pick):
        rows, residual, mean, var = slots[j]
        if residual is None:
            return float("inf")
        Xs = torch.as_tensor(rows, device=st.Xp.device)
        m_ref, v_ref, res_ref = reference_answers(fleet, run, Xs)
        worst = max(worst, compare.dac_error(residual, mean, var, res_ref,
                                             m_ref, v_ref))
    return worst


def check(run, st):
    answered = sorted(st.answers)
    bad = sum(compare.bad_answers(m, v) for m, v in st.answers.values())
    run.check("failed_requests", run.failed)
    run.check("bad_answers", bad)
    pick = sample(run, answered, lambda k: _request(st, k).shape[0])
    if not pick:
        for name in ("mean_err", "var_err", "dac_err"):
            run.check(name, float("inf"))
        return
    Xs = torch.as_tensor(np.concatenate([_request(st, k) for k in pick]),
                         device=st.Xp.device)
    mean = np.concatenate([st.answers[k][0] for k in pick])
    var = np.concatenate([st.answers[k][1] for k in pick])
    fleet = reference_fleet(run, st.Xp, st.yp, "float64")
    m_ref, v_ref, _ = reference_answers(fleet, run, Xs)
    err = compare.answer_errors(mean, var, m_ref, v_ref,
                                run.cfg["true_theta"][run.cfg["input_dim"]])
    run.layer["checked_rows"] = int(Xs.shape[0])
    run.check("mean_err", err["mean_err"])
    run.check("var_err", err["var_err"])
    run.check("dac_err", dac_errors(run, st, fleet))
