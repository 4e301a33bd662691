"""Sharding policy of the LMs: logical parameter/state axes ->
PartitionSpec (counterpart of repro.launch.sharding).

MaxText-style logical axis rules with divisibility fallbacks:

  vocab                      -> model   (replicate if V % 16 != 0)
  embed / embed_out / enc_seq / dec_seq -> (pod, data)  [ZeRO-3 / FSDP]
  heads / kv_heads           -> model   (replicate if not divisible — phi3,
                                         whisper, chatglm kv, xlstm)
  ffn / experts / mamba_inner(2) -> model  (tensor / expert parallel)
  batch                      -> (pod, data)
  kv_seq                     -> every axis the batch left, ONLY for the
                                decode shapes (sequence-sharded cache)
  everything else            -> replicated

A rule only applies when the dim is divisible by the product of the mesh
axis sizes; combined (pod, data) falls back to data alone, then to
replication.

The reference's specs and shardings are JAX's; the port keeps its own:
`PartitionSpec` is a tuple of mesh-axis entries (None, a name, or a tuple
of names) that compares equal to the reference's entries, and
`NamedSharding(mesh, spec).shard_shape(shape)` is each device's block.
Trees are the port's: dicts and lists, with tensors, Python ints (a
cache's index) or tuples of logical axes at the leaves. `with_sharding`
tags meta tensors of the global shape with their sharding (the
reference's sharded `ShapeDtypeStruct`s); `per_device_bytes` sums what
each device holds of them.

Not ported: the reference's `gp_fleet_specs` and `shard_gp_fleet`, which
re-export `core.prediction.expert_specs` / `shard_experts` under a second
name; the port's callers use those two.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class PartitionSpec(tuple):
    """One entry per leading dimension of a tensor: None (replicated), a
    mesh axis name, or a tuple of names (split over their product)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class NamedSharding(NamedTuple):
    """A spec on a mesh (launch.mesh.LMMesh)."""
    mesh: object
    spec: PartitionSpec

    def shard_shape(self, shape) -> tuple:
        """Each device's block of a tensor of `shape`; raises ValueError
        where a split dimension does not divide."""
        out = []
        for i, dim in enumerate(shape):
            n = math.prod(self.mesh.shape[a] for a in
                          _names(self.spec[i] if i < len(self.spec)
                                 else None))
            if dim % n:
                raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                                 f"divide over {self.spec[i]} ({n})")
            out.append(dim // n)
        return tuple(out)


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 0


def _try(mesh, dim: int, *axis_names, used=()):
    """Largest prefix-combination of (unused) axis_names that divides dim."""
    names = [a for a in axis_names if _axis_size(mesh, a) and a not in used]
    while names:
        prod = 1
        for a in names:
            prod *= _axis_size(mesh, a)
        if dim % prod == 0:
            return tuple(names) if len(names) > 1 else names[0]
        names = names[1:]          # drop 'pod' first, then 'data'
    return None


# default logical-axis -> candidate mesh axes (overridable per run by a
# `policy` dict, e.g. launch.dryrun.POLICIES["dp"] for pure data
# parallelism)
DEFAULT_RULES = {
    "vocab": ("model",),
    "embed": ("pod", "data"), "embed_out": ("pod", "data"),
    "enc_seq": ("pod", "data"), "dec_seq": ("pod", "data"),
    "heads": ("model",), "kv_heads": ("model",),
    "ffn": ("model",), "experts": ("model",),
    "mamba_inner": ("model",), "mamba_inner2": ("model",),
    "batch": ("pod", "data"),
}


def spec_for_axes(mesh, axes: tuple, shape: tuple, *,
                  shard_kv_seq: bool = False, policy=None) -> PartitionSpec:
    """Map one leaf's logical axes + shape to a PartitionSpec."""
    entries = []
    used = set()
    rules = dict(DEFAULT_RULES)
    if policy:
        rules.update(policy)

    def place(cand):
        if cand is None:
            return None
        flat = cand if isinstance(cand, tuple) else (cand,)
        if any(a in used for a in flat):
            return None
        used.update(flat)
        return cand

    for name, dim in zip(axes, shape):
        cand = None
        if name in rules:
            cand = _try(mesh, dim, *rules[name], used=used)
        elif name == "kv_seq" and shard_kv_seq:
            # decode shapes: the cache dominates memory; shard its sequence
            # over every mesh axis the batch didn't claim
            cand = _try(mesh, dim, "pod", "data", "model", used=used)
        entries.append(place(cand))
    return P(*entries)


def tree_map(fn, tree, *rest):
    """fn over the leaves of a tree of dicts and lists (tuples are
    leaves), with parallel trees `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_specs(mesh, axes_tree, shape_tree, *, shard_kv_seq: bool = False,
               policy=None):
    """PartitionSpec tree from parallel (axes, shapes) trees; a leaf
    without a shape (a Python int index) is a 0-d leaf."""
    return tree_map(
        lambda ax, leaf: spec_for_axes(mesh, ax, getattr(leaf, "shape", ()),
                                       shard_kv_seq=shard_kv_seq,
                                       policy=policy),
        axes_tree, shape_tree)


def named(mesh, spec_tree):
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


def with_sharding(mesh, shape_tree, spec_tree):
    """Tag each tensor of `shape_tree` with `.sharding =
    NamedSharding(mesh, spec)`: a meta tensor is tagged in place (a meta
    model's parameters stay its own), any other becomes a meta tensor of
    its shape and dtype. Python ints (a cache's index) pass unchanged.
    Raises ValueError where a spec does not divide its tensor."""
    def tag(leaf, spec):
        if not torch.is_tensor(leaf):
            return leaf
        if leaf.device.type != "meta":
            leaf = torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
        sharding = NamedSharding(mesh, spec)
        sharding.shard_shape(leaf.shape)
        leaf.sharding = sharding
        return leaf
    return tree_map(tag, shape_tree, spec_tree)


def per_device_bytes(tree) -> int:
    """Bytes one device holds of a tree of tagged tensors (an
    `nn.Module` counts its parameters): each tensor's shard_shape times
    its element size, and 4 for a Python int (the reference's int32 cache
    index, replicated)."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.nn.Module):
            total += per_device_bytes(list(leaf.parameters()))
        elif isinstance(leaf, tuple):
            total += per_device_bytes(list(leaf))
        elif torch.is_tensor(leaf):
            total += math.prod(leaf.sharding.shard_shape(leaf.shape)) \
                * leaf.element_size()
        elif isinstance(leaf, int):
            total += 4
    return total


def place(tree, mesh, spec_tree):
    """Put each tensor of `tree` (dicts and lists, or an `nn.Module` with
    a {name: spec} tree of its parameters) on `mesh` by its spec and tag
    it, in place for a module. One process holds whole tensors, so every
    spec must leave each tensor whole (its axes of size 1) and the mesh
    must be one device; raises ValueError otherwise."""
    devices = set(mesh.devices)
    if len(devices) != 1:
        raise ValueError(f"place needs a mesh of one device, got "
                         f"{mesh.devices}")
    (device,) = devices

    def put(t, spec):
        sharding = NamedSharding(mesh, spec)
        if sharding.shard_shape(t.shape) != tuple(t.shape):
            raise ValueError(f"{spec} splits a tensor of {tuple(t.shape)}")
        t.data = t.data.to(device)
        t.sharding = sharding
        return t

    if isinstance(tree, torch.nn.Module):
        params = dict(tree.named_parameters())
        for name, spec in spec_tree.items():
            put(params[name], spec)
        return tree
    return tree_map(put, tree, spec_tree)


# ---------------------------------------------------------------------------
# optimizer-state specs
# ---------------------------------------------------------------------------

def adam_state_specs(param_specs):
    return {"step": P(), "m": param_specs, "v": param_specs}


def adafactor_state_specs(param_specs, param_shapes, min_dim_factored=128):
    """Specs of `optim.adafactor`'s state: a leaf whose last two dims are
    both >= min_dim_factored keeps vr (its spec less the last entry) and
    vc (less the one before), any other v (its spec)."""
    def stat_spec(spec, t):
        sh = t.shape
        if len(sh) >= 2 and sh[-1] >= min_dim_factored \
                and sh[-2] >= min_dim_factored:
            return {"vr": P(*spec[:-1]) if len(spec) else P(),
                    "vc": P(*(tuple(spec[:-2]) + (spec[-1],)))
                    if len(spec) >= 2 else P()}
        return {"v": spec}

    return {"step": P(), "stats": tree_map(stat_spec, param_specs,
                                           param_shapes)}
