#!/usr/bin/env python3
"""Where one rbf_matvec launch spends its time, block by block, on a card.

    python3 tools/rbf_matvec_timeline.py [--src SRC_DIR] [--reps N]

Builds csrc/rbf_matvec.cu of SRC_DIR's repro_torch (default: this
repository's) with -DRBF_TIMELINE into a temporary directory, so thread 0
of every block stamps %globaltimer at its start, once its queries are
loaded, after its last stage, after the cluster barrier and at its end,
with its SM. Then it launches the kernel through the C entry point with the
wrapper's geometry at the serving tile (256 x 4 x 8,100, D 2), the sparse
tile (256 x 4 x 512) and the paper's largest fleet (256 x 40 x 810), N
times each after a warm-up, and prints one JSON line per shape (medians
over the N launches): the span from the first block's start to the last
block's end, when the last block started, the blocks' durations and
phases (set-up, stages, cluster barrier, reduction), the SMs used and
the most blocks an SM held at once; and how many clusters of each size
fit the card at once (cudaOccupancyMaxActiveClusters).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(256, 4, 8100, 2), (256, 4, 512, 2), (256, 40, 810, 2)]
STAMPS = 6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import rbf_matvec as K
    if not torch.cuda.is_available():
        print("rbf_matvec_timeline: no CUDA device", file=sys.stderr)
        return 1
    tmp = Path(tempfile.mkdtemp())
    so = tmp / "librbf_matvec_timeline.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-DRBF_TIMELINE",
                    "-o", str(so), str(_build.CSRC / "rbf_matvec.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rbf_matvec_launch.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.rbf_matvec_set_timeline.argtypes = [ptr]
    lib.rbf_matvec_max_active_clusters.argtypes = [i32]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(json.dumps({"max_active_clusters": {
        s: lib.rbf_matvec_max_active_clusters(s) for s in (1, 2, 4, 8)},
        "sms": sms}), flush=True)
    gen = torch.Generator(dev).manual_seed(0)
    for Nt, M, Ni, D in SHAPES:
        a = 2 * torch.rand(Nt, D, generator=gen, device=dev)
        b = 2 * torch.rand(M, Ni, D, generator=gen, device=dev)
        v = torch.randn(M, Ni, generator=gen, device=dev)
        ls = torch.tensor([1.2, 0.3], device=dev)
        sf2 = torch.tensor([1.69], device=dev)
        out = torch.empty(M, Nt, device=dev)
        g = K.geometry(Nt, M, Ni, D, sms)
        buf = torch.zeros(g.blocks * STAMPS, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        runs = []
        for rep in range(args.reps + 1):
            buf.zero_()
            lib.rbf_matvec_set_timeline(buf.data_ptr())
            rc = lib.rbf_matvec_launch(a.data_ptr(), b.data_ptr(),
                                       v.data_ptr(), ls.data_ptr(),
                                       sf2.data_ptr(), out.data_ptr(), Nt, M,
                                       Ni, D, g.splits, stream)
            torch.cuda.synchronize()
            if rc:
                raise RuntimeError(f"launch failed: {rc}")
            if rep == 0:
                continue                                  # warm-up
            t = buf.view(g.blocks, STAMPS).cpu().tolist()
            t0 = min(r[0] for r in t)
            start = [r[0] - t0 for r in t]
            end = [r[4] - t0 for r in t]
            events = sorted([(s_, 1, r[5]) for s_, r in zip(start, t)]
                            + [(e, -1, r[5]) for e, r in zip(end, t)])
            live, most = {}, 0
            for _, step, sm in events:
                live[sm] = live.get(sm, 0) + step
                most = max(most, live[sm])
            runs.append({
                "span_us": max(end) / 1e3,
                "last_start_us": max(start) / 1e3,
                "block_us": statistics.median(e - s_ for s_, e in
                                              zip(start, end)) / 1e3,
                "block_us_max": max(e - s_ for s_, e in zip(start, end))
                / 1e3,
                "setup_us": statistics.median(r[1] - r[0] for r in t) / 1e3,
                "stages_us": statistics.median(r[2] - r[1] for r in t) / 1e3,
                "cluster_sync_us": statistics.median(r[3] - r[2]
                                                     for r in t) / 1e3,
                "reduce_us": statistics.median(r[4] - r[3] for r in t) / 1e3,
                "sms_used": len({r[5] for r in t}),
                "most_blocks_on_an_sm": most})
        row = {"Nt": Nt, "M": M, "Ni": Ni, "D": D, **g._asdict()}
        for k in runs[0]:
            row[k] = statistics.median(r[k] for r in runs)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
