"""Synthetic-but-structured LM token pipeline (a copy of
`repro.data.lm_data`: numpy only, so both packages draw the same batches
from the same seed).

No real corpus is used: the stream is a learnable Markov-ish mixture of
n-gram rules and noise, so training loss measurably decreases (a uniform
stream would give no learning signal). Deterministic per (seed, agent),
so federated agents hold distinct local shards (the paper's assumption
of disjoint local data) of one shared language.
"""
from __future__ import annotations

import numpy as np


class MarkovLMData:
    def __init__(self, vocab_size: int, seed: int = 0, order: int = 2,
                 determinism: float = 0.8, agent: int = 0):
        self.V = vocab_size
        self.rng = np.random.default_rng(seed * 1000 + agent)
        # shared transition structure across agents (same language), agent-
        # specific sampling (disjoint documents)
        struct = np.random.default_rng(seed)
        self.order = order
        self.det = determinism
        self.table = struct.integers(0, vocab_size, size=(vocab_size, order))

    def batch(self, batch_size: int, seq_len: int):
        """Returns (tokens, labels) int32 (B, S); labels = next token."""
        B, S = batch_size, seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = self.rng.integers(0, self.V, B)
        rand = self.rng.random((B, S))
        noise = self.rng.integers(0, self.V, (B, S))
        for t in range(S):
            prev = toks[:, t]
            nxt = self.table[prev % self.V, t % self.order]
            toks[:, t + 1] = np.where(rand[:, t] < self.det, nxt, noise[:, t])
        return toks[:, :-1], toks[:, 1:]
