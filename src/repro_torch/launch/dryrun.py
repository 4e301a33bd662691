"""Pod dry run of the LMs: every (arch x shape x mesh) step planned on
meta tensors (counterpart of repro.launch.dryrun).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xlstm-350m \\
      --shape train_4k [--mesh single|multi|both] [--policy dp]

(every arch and shape by default, the pairs traced in one process a CPU
core but one).

The reference lowers and compiles each step with XLA on 512 forced host
devices. Without a compiler, the counterpart here is to run the step
once on meta tensors of the global shape (launch.steps.build: a meta
model, optimizer state, batch and cache, each tensor tagged with its
sharding on the production mesh), under
`torch.utils.flop_counter.FlopCounterMode`, with `constrain` checking
every pinned intermediate. Nothing is allocated and no device is used:
a pod that no one card can be. A record holds

  status                          "ok", "skipped (...)" or "FAILED"
  trace_s                         the meta step's seconds (in place of the
                                  reference's lower_s and compile_s)
  memory.argument_size_in_bytes   the bytes one device holds of params,
                                  optimizer state, batch and cache under
                                  the specs
  cost.flops                      the global step's count (the matrix
                                  products, forward and backward; the
                                  kernels' plain versions stand in on
                                  meta, so attention counts every
                                  (query, key) pair of its products)

The reference's temporary bytes, transcendentals and collective bytes come
from XLA's compiled program and have no counterpart without a compiler;
the record leaves them out. The meta step does not depend on the mesh or
the policy, so `main` runs it once per (arch, shape) and computes the
specs per (mesh, policy). Records go to `--out` (default
experiments/dryrun_torch, beside the reference's experiments/dryrun).
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCH_IDS, get_config
from . import sharding as shd
from .mesh import make_production_mesh
from .steps import SHAPES, build, shape_supported

# named sharding-policy overrides (launch/sharding.py DEFAULT_RULES keys).
# "dp": pure data parallelism for small models: the model axis joins
# batch/FSDP, tensor-parallel rules disabled.
POLICIES = {
    "default": None,
    "dp": {"batch": ("pod", "data", "model"),
           "embed": ("pod", "data", "model"),
           "embed_out": ("pod", "data", "model"),
           "heads": (), "kv_heads": (), "ffn": (), "vocab": (),
           "mamba_inner": (), "mamba_inner2": ()},
}


_PLAIN = (bool, int, float, str, torch.dtype, torch.device, torch.layout,
          torch.memory_format)


def _key(x):
    """A hashable description of an operator argument: a tensor's
    metadata (a meta kernel sees nothing else), a plain value itself;
    TypeError for anything else."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device.type,
                x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple(_key(a) for a in x)
    if x is None or isinstance(x, _PLAIN):
        return (type(x), x)
    raise TypeError(type(x))


def _describe(out):
    if isinstance(out, torch.Tensor) and out.device.type == "meta":
        return (out.shape, out.stride(), out.dtype, out.storage_offset())
    if isinstance(out, (list, tuple)):
        return (type(out), tuple(_describe(o) for o in out))
    if out is None:
        return None
    raise TypeError(type(out))


def _make(d):
    if d is None:
        return None
    if isinstance(d[0], type):
        return d[0](_make(o) for o in d[1])
    shape, stride, dtype, offset = d
    t = torch.empty_strided(shape, stride, dtype=dtype, device="meta")
    return t.as_strided(shape, stride, offset) if offset else t


class MetaCache(TorchDispatchMode):
    """Reuses the output metadata of a functional operator on meta tensors
    for the same operator and argument metadata: a fresh meta tensor of
    the cached shape, strides and dtype, instead of the operator's Python
    meta kernel (tools/meta_op_cost.py times both; a step's chunk and
    micro-batch loops repeat the same calls thousands of times). Views,
    in-place and out= operators and arguments it cannot describe run as
    they are."""

    def __init__(self):
        super().__init__()
        self.cache = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        schema = func._schema
        if schema.is_mutable or func.is_view or \
                any(r.alias_info for r in schema.returns):
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(tuple(sorted(kwargs.items()))))
        except TypeError:
            return func(*args, **kwargs)
        hit = self.cache.get(key)
        if hit is not None:
            return _make(hit)
        out = func(*args, **kwargs)
        try:
            self.cache[key] = _describe(out)
        except TypeError:
            pass
        return out


def _cfg(arch: str, reduced: bool):
    cfg = get_config(arch)
    return cfg.reduced() if reduced else cfg


def trace_step(arch: str, shape_name: str, reduced: bool = False,
               multi_pod: bool = False, policy: str = "default") -> dict:
    """Run the (arch, shape) step once on meta tensors under
    FlopCounterMode (and `MetaCache`): {"trace_s", "cost": {"flops"}}.
    Raises what the step raises."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.perf_counter()
    step, inputs, _ = build(_cfg(arch, reduced), shape_name, mesh,
                            policy=POLICIES[policy])
    with MetaCache(), FlopCounterMode(display=False) as counter:
        step(*inputs)
    return {"trace_s": round(time.perf_counter() - t0, 3),
            "cost": {"flops": float(counter.get_total_flops())}}


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
            quick_fail: bool = False, policy: str = "default",
            reduced: bool = False, traced: dict | None = None) -> dict:
    """One record: the specs and per-device bytes on the (single- or
    multi-pod) production mesh under `policy`, and the meta step's trace
    (`traced`, from `trace_step`, or run here)."""
    cfg = _cfg(arch, reduced)
    rec = {"arch": cfg.name, "shape": shape_name, "policy": policy,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    if not shape_supported(cfg, shape_name):
        rec["status"] = "skipped (long_500k gate)"
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    try:
        _, inputs, _ = build(cfg, shape_name, mesh, policy=POLICIES[policy])
        rec["memory"] = {"argument_size_in_bytes":
                         shd.per_device_bytes(inputs)}
        rec.update(traced or trace_step(arch, shape_name, reduced,
                                        multi_pod, policy))
        rec["status"] = "ok"
    except Exception as e:
        rec["status"] = "FAILED"
        rec["error"] = "".join(traceback.format_exception_only(e)).strip()
        rec["traceback"] = traceback.format_exc()[-4000:]
        if quick_fail:
            raise
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = "" if policy == "default" else f"_{policy}"
        fn = f"{rec['arch']}_{shape_name}_{rec['mesh']}{suffix}.json" \
            .replace("/", "-")
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def line(rec: dict) -> str:
    """The reference's report line of a record."""
    out = (f"{rec['arch']:28s} {rec['shape']:12s} {rec['mesh']:8s} "
           f"{rec['policy']:8s} {rec['status']}")
    if rec["status"] == "ok":
        mem = rec["memory"]["argument_size_in_bytes"]
        out += (f"  args/dev={mem / 2**30:.2f}GiB "
                f"flops={rec['cost']['flops']:.3g} trace={rec['trace_s']}s")
    elif rec["status"] == "FAILED":
        out += "  " + rec["error"][:160]
    return out


def run_pair(arch: str, shape_name: str, meshes=(False, True),
             policies=("default",), out_dir: str = "",
             reduced: bool = False, quick_fail: bool = False) -> list:
    """Every record of one (arch, shape): its meta step traced once, its
    specs per (mesh, policy)."""
    traced = None
    if shape_supported(_cfg(arch, reduced), shape_name):
        try:
            traced = trace_step(arch, shape_name, reduced, meshes[0],
                                policies[0])
        except Exception:
            if quick_fail:
                raise
    return [run_one(arch, shape_name, mp, out_dir, quick_fail,
                    policy=policy, reduced=reduced, traced=traced)
            for policy in policies for mp in meshes]


def _run_pair(args):
    torch.set_num_threads(1)
    return run_pair(*args)


def run_all(archs, shapes, meshes=(False, True), policies=("default",),
            out_dir: str = "", reduced: bool = False,
            quick_fail: bool = False, jobs: int = 1):
    """Yield the records of every (arch, shape), in order. With jobs > 1
    the pairs run in that many spawned processes (host only: each imports
    torch and touches no device; the train steps, the longest, start
    first), all ended before the first record is yielded."""
    pairs = [(a, s, tuple(meshes), tuple(policies), out_dir, reduced,
              quick_fail) for a in archs for s in shapes]
    if jobs <= 1:
        for args in pairs:
            yield from run_pair(*args)
        return
    order = sorted(range(len(pairs)),
                   key=lambda i: SHAPES[pairs[i][1]]["kind"] != "train")
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(jobs, len(pairs))) as pool:
        done = dict(zip(order, pool.map(_run_pair,
                                        [pairs[i] for i in order],
                                        chunksize=1)))
    for i in range(len(pairs)):
        yield from done[i]


def main(argv=None):
    ap = argparse.ArgumentParser(description="Pod dry run: every (arch x "
                                 "shape x mesh) step on meta tensors")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(SHAPES)} or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--policy", default="default", choices=list(POLICIES))
    ap.add_argument("--quick-fail", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    jobs = min(len(archs) * len(shapes), max(1, (os.cpu_count() or 1) - 1))

    n_fail = 0
    for rec in run_all(archs, shapes, meshes, [args.policy], args.out,
                       quick_fail=args.quick_fail, jobs=jobs):
        n_fail += rec["status"] == "FAILED"
        print(line(rec), flush=True)
    if n_fail:
        print(f"{n_fail} FAILURES", flush=True)
        sys.exit(1)
    print("ALL OK", flush=True)


if __name__ == "__main__":
    main()
