"""TraceRecorder: the host-side tap for training/consensus diagnostics.

The ADMM loops (core.training.admm_*) stack their diagnostics on the
device when called with `diag=True` — per-iteration NLL, primal/dual
residuals, max consensus disagreement, and the theta trajectory, with no
host wait in the loop. The recorder ingests the finished info dict AFTER
the loop returns (tensors leave the device with `.detach().cpu()`: one
device->host copy per series and fit, not per iteration), and the
engine's DAC/JOR per-round residual captures land the same way.

    rec = TraceRecorder()
    fleet.fit(Xp, yp, trace=rec)           # GPFleet threads diag=True
    rec.last()["nll"]                      # (iters, M) per-agent NLL
    rec.summary()                          # final-iteration scalars
    rec.to_jsonl("train_trace.jsonl")      # one line per recorded trace

docs/observability.md explains how to read a trace (what converging
primal/dual residuals look like, per the source paper's §4 story).
"""
from __future__ import annotations

import json

import numpy as np

__all__ = ["TraceRecorder"]

# array-valued diagnostic keys the recorder pulls to host numpy
_ARRAY_KEYS = ("residuals", "primal_residuals", "dual_residuals", "nll",
               "theta_trajectory", "z_history", "dac_residuals",
               "jor_residuals")


class TraceRecorder:
    """Accumulates named diagnostic traces (training runs, consensus
    rounds) as host numpy arrays. Thread-compatible for the single-writer
    pattern the fit path uses; not a concurrent sink."""

    def __init__(self):
        self.traces: list[dict] = []

    def record(self, name: str, info: dict, **meta) -> dict:
        """Ingest one loop's info dict. Array diagnostics (residuals, nll,
        theta trajectories, ...) are copied to host; other entries are
        kept as metadata when JSON-able. Returns the stored entry."""
        entry: dict = {"name": name, **meta}
        src = dict(info.get("diagnostics") or {})
        for k in _ARRAY_KEYS:
            if k in info and k not in src:
                src[k] = info[k]
        for k, v in src.items():
            if hasattr(v, "detach"):           # a torch tensor, any device
                v = v.detach().cpu().numpy()
            try:
                entry[k] = np.asarray(v)
            except Exception:
                entry[k] = v
        self.traces.append(entry)
        return entry

    def last(self) -> dict | None:
        return self.traces[-1] if self.traces else None

    def summary(self) -> list[dict]:
        """Per-trace final-iteration scalars: the convergence endpoint of
        each recorded run (final residuals, final mean NLL, iterations)."""
        out = []
        for t in self.traces:
            s: dict = {"name": t["name"]}
            for k, v in t.items():
                if not isinstance(v, np.ndarray) or v.size == 0:
                    continue
                if k == "theta_trajectory":
                    s["iters"] = int(v.shape[0])
                    continue
                if v.ndim == 1:
                    s[f"final_{k}"] = float(v[-1])
                    s.setdefault("iters", int(v.shape[0]))
                elif k == "nll" and v.ndim == 2:
                    s["final_nll_mean"] = float(np.mean(v[-1]))
                    s["final_nll_max"] = float(np.max(v[-1]))
            out.append(s)
        return out

    def to_jsonl(self, path: str) -> str:
        """One JSON line per trace; arrays become (nested) lists."""
        with open(path, "w") as fh:
            for t in self.traces:
                rec = {}
                for k, v in t.items():
                    if isinstance(v, np.ndarray):
                        rec[k] = np.asarray(v, dtype=np.float64).tolist()
                    else:
                        try:
                            json.dumps(v)
                            rec[k] = v
                        except TypeError:
                            rec[k] = repr(v)
                fh.write(json.dumps(rec, sort_keys=True) + "\n")
        return path

    def __len__(self) -> int:
        return len(self.traces)
