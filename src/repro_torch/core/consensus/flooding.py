"""Flooding (Topkis 1985): broadcast every agent's packet to all agents.

Counterpart of the simulated mode of `repro.core.consensus.flooding`: in
diam(G) rounds of neighbour-wise forwarding every agent holds every
packet, so the simulated network returns the gathered values directly
and reports the round count (diam(G)) for communication accounting
(paper Remark 8).
"""
from __future__ import annotations

from .graph import diameter


def flood(values, A):
    """values (M, ...) -> (gathered (M, ...) available to all, rounds)."""
    return values, int(diameter(A))
