#!/usr/bin/env python3
"""Rate of TF32 mma.sync (m16n8k8, float32 accumulators) on one CUDA card.

    python3 tools/mma_tf32_probe.py

Builds tools/mma_tf32_probe.cu with nvcc (into src/repro_torch/kernels/
build/, listed in .gitignore) and times its loop with CUDA events: the
bare MMA rate, and the rate with each B operand split into TF32 hi and lo
in registers and three MMAs a product (the flash_attention kernel's
float32-accurate scheme; SPLITS names the ways of splitting), at 8 warps
an SM (one 256-thread block, as that kernel runs at D = 128) and at 32.
Prints one JSON object with TFLOP/s (2 * 16 * 8 * 8 flops an MMA) and the
card's name and power limit. The loop's results are not checked: it
measures rates only.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

ITERS = 4096
# the loop's variants (the probe's `split` argument): bare MMAs, then
# three MMAs a product after splitting each B operand by cvt.rna for hi and
# lo, integer rounding for both, integer hi and cvt.rna lo, Veltkamp
SPLITS = ("bare", "split3_cvt", "split3_int", "split3_int_cvt",
          "split3_veltkamp")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mma_tf32_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = _build.BUILD_DIR / "libmma_tf32_probe.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(ROOT / "tools" / "mma_tf32_probe.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_probe_count.restype = ctypes.c_longlong
    lib.mma_probe_count.argtypes = [ctypes.c_int] * 3
    lib.mma_probe_launch.restype = ctypes.c_int
    lib.mma_probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    inp = torch.rand(1024, device="cuda")
    res = {}
    for warps_per_sm, smem in ((8, 150_000), (32, 50_000)):
        blocks = sms * warps_per_sm // 8 * 4     # four waves
        out = torch.empty(blocks * 256, device="cuda")
        for split, name in enumerate(SPLITS):
            def run():
                rc = lib.mma_probe_launch(
                    inp.data_ptr(), out.data_ptr(), blocks, ITERS, split,
                    smem, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"launch failed: {rc}")
            run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                run()
            end.record()
            torch.cuda.synchronize()
            s = start.elapsed_time(end) / 5 / 1e3
            mmas = lib.mma_probe_count(blocks, ITERS, split)
            tf = mmas * 2048 / s / 1e12
            key = f"{name}_{warps_per_sm}warps"
            res[key] = {"ms": 1e3 * s, "mma_tflops": tf,
                        "float32_accurate_tflops": tf / 3 if split else None}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"mma_tf32_probe": res, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
