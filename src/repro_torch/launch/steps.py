"""Prefill and decode steps of the decoder-only LM (counterpart of the
serving half of repro.launch.steps).

The reference's steps take the parameter pytree as their first argument;
here the parameters live in the `LM` module, which takes its place. Both
steps run under `torch.no_grad()`. The train, federated and
speculative step builders come with LM training (ROADMAP A11b).
"""
from __future__ import annotations

import torch

from ..models.lm import check_supported


def make_prefill_step(cfg, max_len: int):
    """prefill(model, tokens (B, P)) -> (logits (B, 1, V), cache): a fresh
    cache of `max_len` positions filled with the prompt's k/v, and the
    logits of the prompt's last position."""
    check_supported(cfg)

    @torch.no_grad()
    def prefill(model, tokens, attention=None):
        cache = model.init_decode_cache(tokens.shape[0], max_len)
        logits, _, cache = model(tokens, cache=cache, logits_slice=1,
                                 attention=attention)
        return logits, cache
    return prefill


def make_decode_step(cfg):
    """decode(model, cache, tokens (B, 1)) -> (logits (B, 1, V), cache)."""
    check_supported(cfg)

    @torch.no_grad()
    def decode(model, cache, tokens):
        logits, _, cache = model(tokens, cache=cache)
        return logits, cache
    return decode
