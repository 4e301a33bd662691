"""Activation sharding hints (counterpart of repro.models.act_sharding):
model code calls constrain(x, logical_axes); the launcher installs a mesh
with use_mesh(); without one, constrain returns its input.

The reference pins the known-large intermediates (the residual stream of
each layer group, the MoE dispatch buffers, the micro-batch split) for
GSPMD. One process has no GSPMD to pin anything, so here `constrain`
under a mesh computes the intermediate's spec (launch/sharding.py) and
checks that the tensor lies on a device of the mesh (on `meta` for a
planned mesh that holds no devices, as in the dry run) and divides as
the spec says, then returns it unchanged.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar

_CTX = ContextVar("act_sharding_ctx", default=None)  # (mesh, kv_seq, policy)


@contextlib.contextmanager
def use_mesh(mesh, shard_kv_seq: bool = False, policy=None):
    token = _CTX.set((mesh, shard_kv_seq, policy))
    try:
        yield
    finally:
        _CTX.reset(token)


def constrain(x, axes: tuple):
    """x unchanged; under `use_mesh`, after checking it is placed and
    divisible as its logical `axes` say (ValueError otherwise)."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    mesh, shard_kv_seq, policy = ctx
    from ..launch.sharding import NamedSharding, spec_for_axes
    spec = spec_for_axes(mesh, axes, x.shape, shard_kv_seq=shard_kv_seq,
                         policy=policy)
    if mesh.devices:
        if x.device not in mesh.devices:
            raise ValueError(f"constrain: a tensor on {x.device} is not on "
                             f"the mesh's devices {mesh.devices}")
    elif x.device.type != "meta":
        raise ValueError(f"constrain: a planned mesh holds no devices, so "
                         f"it takes meta tensors, not one on {x.device}")
    NamedSharding(mesh, spec).shard_shape(x.shape)
    return x
