"""Minimal optimizers as (init, update) pairs, counterpart of
`repro.optim.adam`.

`update` returns *updates* (deltas to add to the params) and
`apply_updates` applies them. Params are a tensor or a dict of tensors. Not `torch.optim.Adam`: FACT-GP needs the reference's float32
`state_dtype` and its bias correction exactly.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: fn(v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree):
    return list(tree.values()) if isinstance(tree, dict) else [tree]


def apply_updates(params, updates):
    return _tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _lr_at(lr, step):
    """A callable lr gets the step as a Python int, so a schedule computes
    in double precision as the reference's does under x64 (a torch int
    tensor would promote it to float32); on the card that reads the step
    back from the device, once a step."""
    return lr(int(step)) if callable(lr) else lr


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    """SGD with optional heavy-ball momentum; `lr` a number or a callable
    of the 1-based step, as in the reference."""
    def init(params):
        dev = _leaves(params)[0].device
        mu = _tree_map(torch.zeros_like, params) if momentum else None
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": mu}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        if momentum:
            mu = _tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            updates = _tree_map(lambda m: -lr_t * m, mu)
        else:
            mu = None
            updates = _tree_map(lambda g: -lr_t * g, grads)
        return updates, {"step": step, "mu": mu}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, grad_clip: float | None = None,
         state_dtype=torch.float32) -> Optimizer:
    def init(params):
        dev = _leaves(params)[0].device
        zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                      device=p.device)
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "m": _tree_map(zeros, params),
                "v": _tree_map(zeros, params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        if grad_clip is not None:
            gnorm = torch.sqrt(sum((g.to(torch.float32) ** 2).sum()
                                   for g in _leaves(grads)))
            scale = torch.clamp(grad_clip / (gnorm + 1e-12), max=1.0)
            grads = _tree_map(lambda g: g * scale, grads)
        m = _tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(state_dtype),
                      state["m"], grads)
        v = _tree_map(lambda v_, g: b2 * v_
                      + (1 - b2) * g.to(state_dtype) ** 2, state["v"], grads)
        bc1 = 1 - b1 ** step.to(state_dtype)
        bc2 = 1 - b2 ** step.to(state_dtype)
        lr_t = _lr_at(lr, step)

        def upd(m_, v_, p):
            u = -lr_t * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u - lr_t * weight_decay * p.to(state_dtype)
            return u

        params_for_wd = params if params is not None else state["m"]
        updates = _tree_map(upd, m, v, params_for_wd)
        return updates, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)
