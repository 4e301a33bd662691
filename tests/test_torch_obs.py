"""The port's observability (repro_torch.obs, the engine's trace counter and
diagnostics mode, GPFleet.fit(trace=) and GPFleet.metrics) against the
JAX package, on the CPU.

* The same operations on a port registry and a reference registry give
  identical Prometheus text, snapshots and histogram quantiles, and the
  parsers agree.
* SpanLog JSONL (explicit timestamps) and TraceRecorder.to_jsonl (equal
  arrays, torch tensors on the port's side) are equal byte for byte.
* MetricsServer serves /metrics and /statusz on an ephemeral loopback
  port.
* The engine's served-geometry count follows the reference's trace count
  on the same request sequence; diagnostics mode's DAC/JOR trajectories
  equal the reference's to 1e-9 in float64 and change no prediction.
* fit(trace=) records the DEC-apx-GP diagnostics of the reference to 1e-6
  relative (the ADMM trajectory gate) and changes no trained theta.
"""
import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.fleet import FleetConfig as JFleetConfig
from repro.fleet import GPFleet as JGPFleet
from repro_torch import obs
from repro_torch.fleet import FleetConfig, GPFleet

torch.set_num_threads(2)

LOG_THETA = np.log([1.2, 0.3, 1.3, 0.1])
SMALL = dict(chunk=16, dac_iters=40, jor_iters=50)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def _drive(reg):
    """One fixed sequence of metric operations."""
    rng = np.random.default_rng(0)
    c = reg.counter("gp_requests_total", "requests by tenant")
    c.inc(tenant="maps")
    c.inc(3, tenant="maps")
    c.inc(2.5, tenant='we"ird,\\name')
    g = reg.gauge("gp_queue_depth", "queued requests")
    g.set(7, tenant="maps")
    g.set_fn(lambda: 42.0, tenant="pull")
    h = reg.histogram("gp_request_latency_seconds", "latency")
    for v in rng.lognormal(-5, 1.5, 500):
        h.observe(v, tenant="maps")
    h2 = reg.histogram("gp_batch_fill", "fill", buckets=(0.25, 0.5, 1.0))
    for v in (0.1, 0.3, 0.3, 0.9, 2.0):
        h2.observe(v)
    reg.disable()
    c.inc(100, tenant="maps")                  # a no-op while disabled
    reg.enable()
    return h


def test_registry_text_snapshot_and_quantiles_match_reference():
    ours, theirs = obs.MetricsRegistry(), jobs.MetricsRegistry()
    h, jh = _drive(ours), _drive(theirs)
    assert obs.prometheus_text(ours) == jobs.prometheus_text(theirs)
    assert ours.snapshot() == theirs.snapshot()
    qs = (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)
    assert h.quantiles(*qs, tenant="maps") == jh.quantiles(*qs,
                                                           tenant="maps")
    text = obs.prometheus_text(ours)
    assert obs.parse_prometheus_text(text) == \
        jobs.parse_prometheus_text(text)
    assert obs.default_latency_buckets() == jobs.default_latency_buckets()
    for bad in ("gp_x{a=b} 1", "gp_x", "gp_x{a=\"b\"} one"):
        with pytest.raises(ValueError):
            obs.parse_prometheus_text(bad)
        with pytest.raises(ValueError):
            jobs.parse_prometheus_text(bad)


def test_span_log_jsonl_matches_reference(tmp_path):
    for mod, name in ((obs, "ours"), (jobs, "theirs")):
        with mod.SpanLog(str(tmp_path / f"{name}.jsonl")) as log:
            s = mod.Span("req-1", t=10.0, tenant="maps", slot=64)
            for stage, t in (("queue", 10.002), ("pack", 10.0025),
                             ("dispatch", 10.003), ("device", 10.011),
                             ("stitch", 10.0112), ("queue", 10.02)):
                s.advance(stage, t=t)
            log.emit(s.event("ok", rows=17))
            log.emit(mod.Span("req-2", t=1.0).event("dropped"))
    ours = (tmp_path / "ours.jsonl").read_text()
    assert ours == (tmp_path / "theirs.jsonl").read_text()
    assert obs.read_spans(str(tmp_path / "ours.jsonl")) == \
        jobs.read_spans(str(tmp_path / "theirs.jsonl"))


def test_trace_recorder_jsonl_matches_reference(tmp_path):
    rng = np.random.default_rng(1)
    arrays = {"nll": rng.normal(size=(5, 4)), "theta_trajectory":
              rng.normal(size=(5, 4, 4)), "primal_residuals": rng.random(5),
              "dual_residuals": rng.random(5)}
    resid = rng.random(5)
    rec, jrec = obs.TraceRecorder(), jobs.TraceRecorder()
    rec.record("dec-apx", {"residuals": torch.tensor(resid),
                           "diagnostics": {k: torch.tensor(v)
                                           for k, v in arrays.items()}},
               num_agents=4, method="rbcm")
    jrec.record("dec-apx", {"residuals": jnp.asarray(resid),
                            "diagnostics": {k: jnp.asarray(v)
                                            for k, v in arrays.items()}},
                num_agents=4, method="rbcm")
    rec.record("consensus", {"dac_residuals": torch.tensor(resid)})
    jrec.record("consensus", {"dac_residuals": jnp.asarray(resid)})
    assert rec.summary() == jrec.summary()
    a = rec.to_jsonl(str(tmp_path / "ours.jsonl"))
    b = jrec.to_jsonl(str(tmp_path / "theirs.jsonl"))
    assert open(a).read() == open(b).read()
    assert len(rec) == 2 and isinstance(rec.last()["dac_residuals"],
                                        np.ndarray)


def test_metrics_server_serves_metrics_and_statusz():
    reg = obs.MetricsRegistry()
    _drive(reg)
    with obs.MetricsServer(port=0, registry=reg) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            text = r.read().decode()
            assert r.headers["Content-Type"].startswith("text/plain")
        with urllib.request.urlopen(base + "/statusz", timeout=10) as r:
            status = json.loads(r.read())
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
    assert text == obs.prometheus_text(reg)
    assert status == json.loads(json.dumps(reg.snapshot()))


# -- the engine and the fleet ------------------------------------------------

@pytest.fixture(scope="module")
def fleets():
    rng = np.random.default_rng(2)
    X = rng.uniform(0, 2, (4 * 24, 2))
    X = X[np.argsort(X[:, 0])]
    y = np.cos(2 * X[:, 0] + X[:, 1]) + 0.1 * rng.normal(size=len(X))
    Xp, yp = X.reshape(4, 24, 2), y.reshape(4, 24)
    fleet = GPFleet(FleetConfig(**SMALL), device="cpu").fit(
        Xp, yp, log_theta0=LOG_THETA, train=False)
    jfleet = JGPFleet(JFleetConfig(**SMALL)).fit(
        jnp.asarray(Xp), jnp.asarray(yp), log_theta0=jnp.asarray(LOG_THETA),
        train=False)
    return fleet, jfleet, (Xp, yp), rng.uniform(0, 2, (20, 2))


def test_trace_count_follows_reference(fleets):
    """The same request sequence: the engine's served-geometry count and
    the gp_jit_traces_total counter move as the reference's traces do."""
    fleet, jfleet, _, Xs = fleets
    counter = obs.default_registry().counter("gp_jit_traces_total")
    before = counter.value(engine="replicated", method="gpoe")
    seq = [("gpoe", 20), ("gpoe", 20), ("gpoe", 12), ("poe", 20),
           ("gpoe", 20)]
    for method, n in seq:
        fleet.predict(Xs[:n], method=method)
        jfleet.predict(jnp.asarray(Xs[:n]), method=method)
        assert fleet.jit_cache_misses == jfleet.jit_cache_misses
    assert counter.value(engine="replicated", method="gpoe") == before + 2
    for eng in (fleet.engine, jfleet.engine):
        eng.set_diagnostics(True)
        eng.set_diagnostics(False)
    fleet.predict(Xs, method="gpoe")
    jfleet.predict(jnp.asarray(Xs), method="gpoe")
    assert fleet.jit_cache_misses == jfleet.jit_cache_misses


@pytest.mark.parametrize("method", ["rbcm", "nn_gpoe", "npae", "npae_star"])
def test_diagnostics_trajectories_match_reference(fleets, method):
    fleet, jfleet, _, Xs = fleets
    m0, v0, i0 = fleet.predict(Xs, method=method)
    assert "dac_residuals" not in i0
    for eng in (fleet.engine, jfleet.engine):
        eng.set_diagnostics(True)
    try:
        m1, v1, info = fleet.predict(Xs, method=method)
        _, _, jinfo = jfleet.predict(jnp.asarray(Xs), method=method)
    finally:
        for eng in (fleet.engine, jfleet.engine):
            eng.set_diagnostics(False)
    assert torch.equal(m0, m1) and torch.equal(v0, v1)
    assert info["dac_residuals"].shape == (SMALL["dac_iters"],)
    _close(info["dac_residuals"], jinfo["dac_residuals"], 1e-9)
    if method.startswith("npae"):
        assert info["jor_residuals"].shape == (SMALL["jor_iters"],)
        _close(info["jor_residuals"], jinfo["jor_residuals"], 1e-9)
        assert float(info["jor_residuals"][-1]) == pytest.approx(
            float(info["jor_residual"]))


def test_fit_trace_records_reference_diagnostics(fleets, tmp_path):
    _, _, (Xp, yp), _ = fleets
    cfg = dict(SMALL, admm_iters=8, kappa=2_000.0)
    rec, jrec = obs.TraceRecorder(), jobs.TraceRecorder()
    f1 = GPFleet(FleetConfig(**cfg), device="cpu").fit(Xp, yp, trace=rec)
    JGPFleet(JFleetConfig(**cfg)).fit(jnp.asarray(Xp), jnp.asarray(yp),
                                      trace=jrec)
    t, jt = rec.last(), jrec.last()
    assert t["name"] == "dec-apx" and t["num_agents"] == 4
    assert set(t) == set(jt)
    for k in ("nll", "primal_residuals", "dual_residuals",
              "theta_trajectory", "residuals"):
        assert t[k].shape == jt[k].shape
        _close(t[k], jt[k], 1e-6)
    assert t["nll"].shape == (8, 4)
    s, js = rec.summary()[0], jrec.summary()[0]
    assert set(s) == set(js) and s["iters"] == js["iters"] == 8
    f2 = GPFleet(FleetConfig(**cfg), device="cpu").fit(Xp, yp)
    assert torch.equal(f1.thetas, f2.thetas)
    row = json.loads(open(rec.to_jsonl(str(tmp_path / "t.jsonl"))).readline())
    assert row["name"] == "dec-apx" and len(row["residuals"]) == 8


def test_fleet_metrics_block_and_prometheus_agree(fleets):
    fleet, jfleet, _, Xs = fleets
    fleet.predict(Xs, method="bcm")
    snap, jsnap = fleet.metrics(), jfleet.metrics()
    assert set(snap["fleet"]) == set(jsnap["fleet"])
    assert snap["fleet"]["is_fitted"] is True
    assert snap["fleet"]["jit_cache_misses"] == fleet.jit_cache_misses
    fams = obs.parse_prometheus_text(obs.prometheus_text())
    series = {tuple(sorted(s["labels"].items())): s["value"]
              for s in snap["gp_jit_traces_total"]["series"]}
    parsed = {tuple(sorted(labels.items())): v
              for labels, v in fams["gp_jit_traces_total"]}
    assert series == parsed
    assert series[(("engine", "replicated"), ("method", "bcm"))] >= 1
