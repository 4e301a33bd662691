#!/usr/bin/env python3
"""What a dry run on meta tensors costs on the host: microseconds per call
of a few operators on meta tensors (PyTorch's meta kernels for them are
Python), and one (arch, shape) step of launch/dryrun.py traced under
FlopCounterMode with and without `MetaCache`.

    PYTHONPATH=src python3 tools/meta_op_cost.py [--step xlstm-350m:prefill_32k]
        [--calls 2000]

Prints one JSON line: {"op_us": {...}, "step": {"cached_s", "uncached_s",
"flops_equal"}}. Host only; no device is used.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build


def op_us(calls: int) -> dict:
    a = torch.empty(256, 4, 256, device="meta")
    r = torch.empty(4, 256, 768, device="meta")
    ops = {"add": lambda: a + a, "mul": lambda: a * a,
           "exp": lambda: torch.exp(a), "tanh": lambda: torch.tanh(a),
           "maximum": lambda: torch.maximum(a, a),
           "clamp": lambda: a.clamp(min=1.0),
           "einsum": lambda: torch.einsum("bhk,hkl->bhl", a, r)}
    out = {}
    for name, fn in ops.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = 1e6 * (time.perf_counter() - t0) / calls
    return out


def step_s(arch: str, shape: str, cached: bool):
    step, inputs, _ = build(get_config(arch), shape, make_production_mesh())
    t0 = time.perf_counter()
    with (dryrun.MetaCache() if cached else contextlib.nullcontext()), \
            FlopCounterMode(display=False) as counter:
        step(*inputs)
    return time.perf_counter() - t0, counter.get_total_flops()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--step", default="xlstm-350m:prefill_32k")
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args(argv)
    arch, shape = args.step.split(":")
    step_s(arch, shape, True)              # warm the meta kernels' imports
    cached, f_cached = step_s(arch, shape, True)
    uncached, f_uncached = step_s(arch, shape, False)
    print(json.dumps({"op_us": op_us(args.calls),
                      "step": {"arch": arch, "shape": shape,
                               "cached_s": cached, "uncached_s": uncached,
                               "flops_equal": f_cached == f_uncached}}),
          flush=True)


if __name__ == "__main__":
    main()
