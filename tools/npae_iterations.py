#!/usr/bin/env python3
"""DEC-NPAE* and the CBNN-masked DEC-NPAE against their iteration counts
on the paper fleet, on one CUDA card.

    python3 tools/npae_iterations.py [--seed N]

The fleet is chip_smoke.py's methods fleet without the grBCM experts: the
paper's 32,400 points of one field draw in 4 stripes of 8,100 on a path
graph, fitted at the true hyperparameters. Its first 256-query tile is
served by npae_star at JOR_COUNTS JOR iterations in float32 and in
float64 (the same points), and by nn_npae at DALE_COUNTS DALE iterations
in float32. Each line gives the RMSE against the noise-free field, the
final JOR or DALE residual and the batch's ms on the host's clock (a
synchronize after it). The card's name and power limit head the output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JOR_COUNTS = (500, 2_000, 5_000, 20_000, 50_000)
DALE_COUNTS = (2_000, 10_000, 40_000)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("npae_iterations: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import (BATCH, TRUE_THETA, _rmse, card_line,
                            paper_data)
    from repro_torch.core.gp import pack
    from repro_torch.core.prediction import PredictionEngine, fit_experts
    from repro_torch.core.consensus import path_graph
    print(card_line(), flush=True)
    Xp, yp, Xq, fq = paper_data({"seed": args.seed})
    Xt, ft = Xq[:BATCH], fq[:BATCH]
    A = path_graph(4)
    for dtype, method, key, counts in (
            (torch.float32, "npae_star", "jor_iters", JOR_COUNTS),
            (torch.float64, "npae_star", "jor_iters", JOR_COUNTS),
            (torch.float32, "nn_npae", "dale_iters", DALE_COUNTS)):
        lt = pack(*TRUE_THETA, dtype=dtype, device="cuda")
        fitted = fit_experts(lt, Xp.to(dtype), yp.to(dtype))
        for it in counts:
            e = PredictionEngine(fitted, A, device="cuda", **{key: it})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m, _, info = e.predict(method, Xt.to(dtype))
            torch.cuda.synchronize()
            res = "jor_residual" if key == "jor_iters" else "dale_residual"
            print(json.dumps({
                "method": method, "dtype": str(dtype).split(".")[-1],
                key: it, "rmse_first_tile": _rmse(m, ft),
                res: float(info[res]),
                "batch_ms": 1e3 * (time.perf_counter() - t0)}), flush=True)
        del fitted
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
