"""The system under test, as the benchmark drives it: the PyTorch port's
`GPFleet` facade (and through it the front door, the engine, the trainers,
the streaming windows and the CUDA kernels), configured from a
configuration file. The only module of the benchmark that imports the
program."""
from __future__ import annotations

import contextlib
import math

import torch
from repro_torch.core.prediction import decentralized
from repro_torch.fleet import FleetConfig, GPFleet
from repro_torch.obs import default_registry  # noqa: F401 (the spans' sink)

FLEET_KEYS = ("input_dim", "num_agents", "graph", "trainer", "rho", "kappa",
              "method", "chunk", "dac_iters", "jitter", "stream_mean",
              "online", "window")


def fleet_config(cfg: dict, **overrides):
    kw = {k: cfg[k] for k in FLEET_KEYS if k in cfg}
    kw["theta0"] = tuple(cfg["theta0"])
    kw.update(overrides)
    return FleetConfig(**kw)


def log_theta(theta, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor([math.log(t) for t in theta], dtype=dtype,
                        device=device)


def fleet(cfg: dict, device, A=None, **overrides):
    return GPFleet(fleet_config(cfg, **overrides), A=A, device=device)



def record_slots(srv, sink: list):
    """Record every slot the front door's one tenant dispatches from now
    on as (the slot's query rows, its info["dac_residual"], mean, var): the
    engine's own report of how far its agents' DAC estimates still differ,
    beside the slot's answers. They stay on the device until the check
    reads them, so the record adds no synchronisation to the timed path."""
    tenant = srv._get(None)
    served = tenant.predict_fn

    def recorded(batch):
        out = served(batch)
        sink.append((batch, out[2].get("dac_residual"), out[0], out[1]))
        return out
    tenant.predict_fn = recorded


@contextlib.contextmanager
def no_exchange():
    """A planted fault: the serving engine's DAC sweeps run with no edge
    (A = 0, so each agent keeps its own payload). The served mean over the
    agents is unchanged; only the agents' disagreement shows it."""
    dac = decentralized.dac
    decentralized.dac = lambda w0, A, iters, eps=None: dac(
        w0, torch.zeros_like(A), iters, eps)
    try:
        yield
    finally:
        decentralized.dac = dac
