#!/usr/bin/env python3
"""Time LM serving of checkouts against each other on one card.

    python3 tools/decode_compare.py --tree old=PATH --tree new=. \\
        --order old,new,new,old [--out FILE]

Each TREE is the root of a checkout of this repository (its `src/` holds a
`repro_torch`). The trees run one after another in the given order, each
in its own process, all on the same card (tools/rbf_matvec_compare.py's
`run_trees`), and each prints one JSON line:
chip_smoke.py's lm phase workload (internlm2-1.8b at its published widths
and depth, float32 weights and prompts drawn from seed 0, a batch of 4
prompts of 2,048 tokens, 32 greedy tokens) through the tree's
`repro_torch.launch.serve.generate`, served GENERATIONS times in a row:
prefill ms and decode ms a step of each (host clock, synchronized), and
whether every run generated the same tokens. The card's name and power
limit head the output.
"""
from __future__ import annotations

import sys

from rbf_matvec_compare import run_trees

ARCH, BATCH, PROMPT, GEN, GENERATIONS = "internlm2-1.8b", 4, 2048, 32, 4


def worker(src: str) -> dict:
    sys.path.insert(0, src)
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import LM
    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    gen = torch.Generator(dev).manual_seed(0)
    model = LM(cfg, device=dev, generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=dev)
    runs, tokens = [], []
    for _ in range(GENERATIONS):
        out = generate(model, prompts, GEN)
        runs.append({"prefill_ms": 1e3 * out["prefill_s"],
                     "decode_ms_per_step": 1e3 * out["decode_s"] / GEN})
        tokens.append(out["tokens"])
    return {"src": src, "arch": ARCH, "batch": BATCH, "prompt": PROMPT,
            "gen": GEN, "runs": runs,
            "same_tokens": all(torch.equal(t, tokens[0]) for t in tokens)}


if __name__ == "__main__":
    sys.exit(run_trees(__file__, worker, __doc__))
