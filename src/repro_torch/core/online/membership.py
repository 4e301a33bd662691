"""Dynamic agent membership for a streaming fleet.

Counterpart of `repro.core.online.membership`. Agents join and leave a
live fleet; both change the agent axis, and the returned (state, A) pair
reaches the serving engine through `PredictionEngine.rewire`. The DAC
consensus is stateless across predict calls, so re-syncing it means a new
adjacency and nothing else. Connectivity is preserved by construction: a
joiner attaches to at least one existing agent, and a leaver's former
neighbors are re-chained (consensus over a disconnected graph silently
averages per component).
"""
from __future__ import annotations

import torch

from ..consensus.graph import attach_agent, is_connected, remove_agent
from .experts import OnlineExperts, from_batch, init_online

_FIELDS = ("Xw", "yw", "L", "alpha", "count")


def join(state: OnlineExperts, A, X_new=None, y_new=None, neighbors=None):
    """Add one agent; returns (state', A') with M+1 agents.

    `X_new (n, D)` / `y_new (n,)` seed the joiner's window (last W points
    kept); omitted, it joins empty and warms up through `observe`.
    `neighbors` are the existing agents it can exchange messages with
    (default: the current last agent — extends a path/ring topology).
    """
    M, W, D = state.Xw.shape
    if neighbors is None:
        neighbors = (M - 1,)
    jitter = float(state.jitter)
    if X_new is not None:
        dev, dtype = state.Xw.device, state.Xw.dtype
        X_new = torch.as_tensor(X_new, device=dev, dtype=dtype)
        y_new = torch.as_tensor(y_new, device=dev, dtype=dtype)
        new = from_batch(state.log_theta, X_new[None], y_new[None],
                         window=W, jitter=jitter)
    else:
        new = init_online(state.log_theta, 1, W, D, dtype=state.Xw.dtype,
                          jitter=jitter)
    merged = state._replace(**{
        name: torch.cat([getattr(state, name), getattr(new, name)])
        for name in _FIELDS})
    return merged, attach_agent(A, neighbors)


def leave(state: OnlineExperts, A, agent: int):
    """Remove agent `agent`; returns (state', A') with M-1 agents, former
    neighbors re-chained so the consensus graph stays connected."""
    M = state.num_agents
    agent = int(agent)
    if not 0 <= agent < M:
        raise ValueError(f"agent {agent} not in fleet of {M}")
    if M <= 1:
        raise ValueError("cannot remove the last agent")
    keep = torch.tensor([m for m in range(M) if m != agent],
                        device=state.Xw.device)
    shrunk = state._replace(**{name: getattr(state, name)[keep]
                               for name in _FIELDS})
    A2 = remove_agent(A, agent, reconnect=True)
    if not is_connected(A2):
        raise AssertionError("leave() broke graph connectivity")
    return shrunk, A2
