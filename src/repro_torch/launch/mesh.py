"""Meshes: the LM's (data, model) meshes and the agent mesh of the
sharded GP fleet (counterpart of `repro.launch.mesh`).

The reference's meshes are `jax.sharding.Mesh`es driven by one
controller. Here a mesh is a named tuple of axis names, axis sizes and
`torch.device`s, driven by one process:

  LMMesh     ("data", "model"), or ("pod", "data", "model") for two
             pods. `make_production_mesh` holds no devices: it is the pod
             that the sharding specs plan for (launch/sharding.py,
             launch/dryrun.py), what the reference's 512 forced host
             devices stand for. `make_test_mesh` takes the visible cards,
             or the devices it is given, row-major over its axes.
  AgentMesh  the one axis "agents": member i owns a contiguous block of
             agents, and the ring collectives (`core.consensus.dac`)
             move a member's tensor to the next member's device.

Several members may share a device: `("cuda:0",) * 4` runs every hop of
a four-member ring on one card, as the reference's forced host devices
do on the CPU, and `("cpu",) * k` is the CPU tests' mesh. Functions
only: importing this module touches no device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import resolve_device


class LMMesh(NamedTuple):
    """An n-D mesh over named axes; `devices` (row-major over the axes)
    is empty for a planned mesh that no process holds."""
    axis_names: tuple
    axis_sizes: tuple
    devices: tuple = ()

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> LMMesh:
    """Single pod: (16, 16) ("data", "model") = 256 chips.
    Multi-pod:  (2, 16, 16) ("pod", "data", "model") = 512 chips.
    A plan: it holds no devices."""
    if multi_pod:
        return LMMesh(("pod", "data", "model"), (2, 16, 16))
    return LMMesh(("data", "model"), (16, 16))


def make_test_mesh(data: int = 1, model: int = 1, devices=None) -> LMMesh:
    """A (data, model) mesh over the first data * model of `devices`
    (default: every visible card). Raises when no card is visible and no
    `devices` were given, or when there are too few devices."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device is available for the test mesh: pass "
                "devices=('cpu',) * k to build a mesh on the CPU")
        devices = tuple(f"cuda:{i}" for i in range(n))
    pool = tuple(resolve_device(d) for d in devices)
    if len(pool) < data * model:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"devices, got {len(pool)}")
    return LMMesh(("data", "model"), (data, model), pool[:data * model])


def data_axes(mesh) -> tuple:
    """The batch/FSDP axes present in this mesh ('pod' first if it
    exists)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


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
