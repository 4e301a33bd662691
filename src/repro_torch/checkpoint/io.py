"""Tree checkpointing: flattened leaves in a .npz + structure manifest.

Counterpart of `repro.checkpoint.io`, with the SAME on-disk format, so a
checkpoint written by either package loads into the other:

  step_XXXXXXXX.npz  one array per leaf, keyed by its path string
  manifest.json      {"treedef", "step", "leaves": {key: {shape, dtype}}}

A tree is made of dicts (keys visited in sorted order), NamedTuples
(fields in order), lists and tuples; None is an empty subtree (it has no
leaf and no key), and anything else is a leaf: a tensor on any device, a
numpy array or a Python scalar. `leaf_keys` spells each leaf's path as
`jax.tree_util.keystr` does ("['fitted'].L", "['x'][0]"); tests hold the
two to each other. The manifest's "treedef" is descriptive only (neither
package parses it: `restore` takes the caller's template), so the port
writes its own rendering of the structure there.

Single-host: one .npz per step. Every file lands by temp file + fsync +
rename, arrays before the manifest, so a reader never sees a half-written
checkpoint.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch


class LeafSpec:
    """Shape and dtype of one template leaf (the role of the reference's
    `jax.ShapeDtypeStruct`); a leaf, not a tree node."""
    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """[(key piece, child)] of a tree node, or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", v) for f, v in zip(node._fields, node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def tree_flatten_with_path(tree, prefix: str = "") -> list[tuple[str, object]]:
    """[(path string, leaf)] in the reference's flattening order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for piece, child in kids:
        out.extend(tree_flatten_with_path(child, prefix + piece))
    return out


def leaf_keys(tree) -> list[str]:
    """The path strings of `tree`'s leaves, in flattening order: the npz
    keys `jax.tree_util.keystr` gives the reference's leaves."""
    return [k for k, _ in tree_flatten_with_path(tree)]


def tree_unflatten(template, leaves):
    """`template`'s structure with its leaves replaced, in flattening
    order, from the iterable `leaves`."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(template)


def tree_structure(tree) -> str:
    """A readable rendering of the structure (manifest "treedef")."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {tree_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return (f"{type(tree).__name__}("
                + ", ".join(tree_structure(v) for v in tree) + ")")
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(tree_structure(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _spec(leaf) -> tuple[tuple, np.dtype]:
    """(shape, numpy dtype) of a template leaf."""
    if not hasattr(leaf, "dtype"):
        leaf = np.asarray(leaf)
    return tuple(leaf.shape), _np_dtype(leaf.dtype)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in tree_flatten_with_path(tree)}


def _atomic_publish(tmp_path: str, final_path: str):
    """fsync + rename: a crash mid-save leaves the previous complete file
    (or nothing), never a truncated one."""
    with open(tmp_path, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp_path, final_path)


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.npz")


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    """Write the step's leaves (.npz) and manifest.json, each by temp file
    + rename, arrays before the manifest, so every state a reader can see
    is loadable. Tensors leave their device with one copy each."""
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves = _flatten(tree)
    path = _step_path(ckpt_dir, step)
    np.savez(path + ".tmp.npz", **leaves)      # np.savez keeps the .npz
    _atomic_publish(path + ".tmp.npz", path)
    mpath = os.path.join(ckpt_dir, "manifest.json")
    with open(mpath + ".tmp", "w") as f:
        json.dump({"treedef": tree_structure(tree), "step": step,
                   "leaves": {k: {"shape": list(v.shape),
                                  "dtype": str(v.dtype)}
                              for k, v in leaves.items()}}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(mpath + ".tmp", mpath)
    return path


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for fn in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)\.npz$", fn))]
    return max(steps) if steps else None


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, order="C")).to(device)


def load_checkpoint(ckpt_dir: str, step: int, like_tree, device="cpu"):
    """Restore into the structure of `like_tree`, unvalidated: a missing
    leaf is a bare KeyError and shape/dtype drift goes unnoticed. Prefer
    `restore`."""
    data = np.load(_step_path(ckpt_dir, step))
    return tree_unflatten(like_tree, [_tensor(data[k], device)
                                      for k in leaf_keys(like_tree)])


def restore(ckpt_dir: str, template, step: int | None = None,
            device="cpu"):
    """Validated restore: load `step` (default: the latest) into the
    structure of `template` (leaves: tensors, arrays or LeafSpecs) and
    check every leaf against it. Fails with a full report on:

      * a template leaf missing from the checkpoint,
      * a stored leaf the template does not expect,
      * a shape or dtype that disagrees.

    Returns the template's structure with C-contiguous tensors on
    `device` as its leaves."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint steps in {ckpt_dir!r}")
    path = _step_path(ckpt_dir, step)
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint {path!r} does not exist")
    data = np.load(path)
    want = dict(tree_flatten_with_path(template))
    errors = []
    missing = sorted(set(want) - set(data.files))
    extra = sorted(set(data.files) - set(want))
    if missing:
        errors.append(f"leaves missing from checkpoint: {missing}")
    if extra:
        errors.append(f"stored leaves the template does not expect: {extra}")
    for key in sorted(set(want) & set(data.files)):
        tmpl, stored = want[key], data[key]
        t_shape, t_dtype = _spec(tmpl)
        if t_shape != stored.shape:
            errors.append(f"{key}: template shape {t_shape} != stored "
                          f"{stored.shape}")
        elif t_dtype != stored.dtype:
            errors.append(f"{key}: template dtype {t_dtype} != stored "
                          f"{stored.dtype}")
    if errors:
        raise ValueError(
            f"checkpoint {path!r} does not match the template:\n  "
            + "\n  ".join(errors))
    return tree_unflatten(template, [_tensor(data[k], device)
                                     for k in want])
