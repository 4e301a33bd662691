"""Flooding (Topkis 1985): broadcast every agent's packet to all agents.

Counterpart of the simulated mode of `repro.core.consensus.flooding`: in
diam(G) rounds of neighbour-wise forwarding every agent holds every
packet, so the simulated network returns the gathered values directly
and reports the round count (diam(G)) for communication accounting
(paper Remark 8). Sharded mode gathers every mesh member's packet on
every member by forwarding it around the ring (`dac.ring_allgather`).
"""
from __future__ import annotations

from .graph import diameter


def flood(values, A):
    """values (M, ...) -> (gathered (M, ...) available to all, rounds)."""
    return values, int(diameter(A))


def flood_sharded(values):
    """One packet per mesh member -> on every member the stacked packets
    (n, ...) of all members, by n - 1 neighbour hops."""
    from .dac import ring_allgather
    return ring_allgather(values)
