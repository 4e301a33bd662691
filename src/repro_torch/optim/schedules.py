"""Learning-rate schedules as step -> lr callables (counterpart of
`repro.optim.schedules`).

The optimizers hand a schedule the 1-based step as a Python int
(`adam._lr_at`), so a schedule computes in double precision, as the
reference's does under x64. `constant` returns the float32 value of `lr`
(as a Python float), as the reference returns a float32 array."""
from __future__ import annotations

import math

import numpy as np


def constant(lr: float):
    value = float(np.float32(lr))
    return lambda step: value


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    """lr (final_frac + (1 - final_frac) (1 + cos(pi t)) / 2), t = step /
    total_steps clipped to [0, 1]."""
    def f(step):
        t = min(max(step / total_steps, 0.0), 1.0)
        return lr * (final_frac
                     + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * t)))
    return f


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warm-up to lr over `warmup_steps`, then `cosine` over the
    remaining steps."""
    cos = cosine(lr, max(total_steps - warmup_steps, 1), final_frac)

    def f(step):
        if step < warmup_steps:
            return lr * step / max(warmup_steps, 1)
        return cos(step - warmup_steps)
    return f
