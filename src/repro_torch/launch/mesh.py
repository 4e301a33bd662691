"""The agent mesh of the sharded GP fleet.

Counterpart of `repro.launch.mesh`'s `make_agent_mesh` (the LM meshes,
`make_production_mesh` and `make_test_mesh`, come with the LM's sharding,
ROADMAP A7b). The reference's mesh is a `jax.sharding.Mesh` driven by one
controller; here it is a tuple of `torch.device`s on the one axis
"agents", driven by one process: member i owns a contiguous block of
agents, and the ring collectives (`core.consensus.dac`) move a member's
tensor to the next member's device. Several members may share a device:
`("cuda:0",) * 4` runs every hop of a four-member ring on one card, as
the reference's forced host devices do on the CPU, and `("cpu",) * k` is
the CPU tests' mesh. Functions only: importing this module touches no
device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device


class AgentMesh(NamedTuple):
    """A 1-D mesh: one device per member along the axis "agents"."""
    devices: tuple

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("agents",)

    @property
    def shape(self) -> dict[str, int]:
        return {"agents": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_agent_mesh(num_agents: int, *, max_devices: int | None = None,
                    devices=None) -> AgentMesh:
    """1-D mesh over the "agents" axis for the sharded fleet.

    Takes the LARGEST number of members, out of `devices` (default: every
    visible card) and at most `max_devices`, that divides `num_agents`
    (the sharded engine needs ndev | M), and one member when nothing
    larger divides — the sharded program is still valid there (the ring
    collectives degenerate to the identity). Raises when no card is
    visible and no `devices` were given.
    """
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device is available for the agent mesh: pass "
                "devices=('cpu',) * k to build a mesh on the CPU")
        devices = tuple(f"cuda:{i}" for i in range(n))
    # resolve_device also keeps TF32 off on the card, as every entry
    # point of the port does
    pool = tuple(resolve_device(d) for d in devices)
    if not pool:
        raise ValueError("make_agent_mesh needs at least one device")
    avail = len(pool) if max_devices is None else min(len(pool),
                                                      int(max_devices))
    ndev = max(d for d in range(1, max(avail, 1) + 1) if num_agents % d == 0)
    return AgentMesh(pool[:ndev])


def mesh_for(num_agents: int, device, *, max_devices: int | None = None
             ) -> AgentMesh:
    """The default mesh of a fleet on `device`: every visible card for a
    fleet on the card, the device alone otherwise (one member)."""
    device = torch.device(device)
    return make_agent_mesh(
        num_agents, max_devices=max_devices,
        devices=None if device.type == "cuda" else (device,))
