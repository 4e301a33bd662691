"""Parameters between the reference's pytree layout and the port's LM.

The reference's dense transformer keeps its layers stacked for
`jax.lax.scan` (repro/models/lm.py `param_defs`):

    embed (V, d), final_norm (d,), lm_head (d, V) unless tied,
    blocks/dense/{ln1, attn/{wq, wk, wv, wo}, ln2, mlp/{wg, wu, wd}}

where every block leaf carries two leading axes (n_groups, 1): the scan
over layer groups and the stack of one dense layer inside a group. Layer
l of the port is group l. Arrays cross as numpy arrays, so this module
imports nothing of the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from .lm import LM

_ATTN = ("wq", "wk", "wv", "wo")


def _layer_leaves(blk):
    """(path, parameter) of one port block in the reference's names."""
    yield ("ln1",), blk.ln1.weight
    yield ("ln2",), blk.ln2.weight
    for name in _ATTN:
        yield ("attn", name), getattr(blk.attn, name)
    for name, w in blk.mlp.named_parameters():
        yield ("mlp", name), w


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@torch.no_grad()
def lm_params_from_jax(cfg, tree, device=None) -> LM:
    """An `LM` holding the reference's parameter tree `tree` (a nested dict
    of numpy arrays, e.g. `jax.tree.map(np.asarray, lm.init_params(...))`),
    in the arrays' dtype, on `device` (default: the card)."""
    embed = np.asarray(tree["embed"])
    dtype = torch.from_numpy(np.zeros(0, embed.dtype)).dtype
    model = LM(cfg, device=device, dtype=dtype, init=False)

    def put(param, array):
        array = np.asarray(array)
        if array.shape != tuple(param.shape):
            raise ValueError(f"parameter shape {array.shape} does not match "
                             f"the port's {tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.array(array)))

    put(model.embed, embed)
    put(model.final_norm.weight, tree["final_norm"])
    if model.lm_head is not None:
        put(model.lm_head, tree["lm_head"])
    dense = tree["blocks"]["dense"]
    n_groups = np.asarray(dense["ln1"]).shape[0]
    if n_groups != cfg.num_layers or np.asarray(dense["ln1"]).shape[1] != 1:
        raise ValueError(f"want blocks stacked (num_layers, 1, ...), got "
                         f"{np.asarray(dense['ln1']).shape[:2]}")
    for l, blk in enumerate(model.blocks):
        for path, param in _layer_leaves(blk):
            put(param, np.asarray(_get(dense, path))[l, 0])
    return model


@torch.no_grad()
def lm_params_to_jax(model: LM) -> dict:
    """The reference's parameter tree of `model`, as numpy arrays."""
    return lm_tree_to_jax(model, dict(model.named_parameters()))


@torch.no_grad()
def lm_tree_to_jax(model: LM, named: dict) -> dict:
    """Per-parameter tensors of `model` in the reference's stacked layout,
    as numpy arrays: `named` maps each name of `model.named_parameters()`
    to a tensor of that parameter's shape (the parameters themselves, a
    gradient, an optimizer's moment), e.g. {n: p.grad for n, p in
    model.named_parameters()} for the tree `jax.grad` gives."""
    by_param = {id(p): n for n, p in model.named_parameters()}
    if set(named) != set(by_param.values()):
        raise ValueError(f"want one tensor per parameter of the model; "
                         f"missing {sorted(set(by_param.values()) - set(named))}"
                         f", unknown {sorted(set(named) - set(by_param.values()))}")

    def arr(param):
        t = named[by_param[id(param)]]
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"{by_param[id(param)]}: shape "
                             f"{tuple(t.shape)} is not the parameter's "
                             f"{tuple(param.shape)}")
        return t.detach().cpu().numpy()

    tree = {"embed": arr(model.embed),
            "final_norm": arr(model.final_norm.weight)}
    if model.lm_head is not None:
        tree["lm_head"] = arr(model.lm_head)
    dense = {}
    for path, _ in _layer_leaves(model.blocks[0]):
        stacked = np.stack([arr(dict(_layer_leaves(b))[path])
                            for b in model.blocks])[:, None]
        node = dense
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = stacked
    tree["blocks"] = {"dense": dense}
    return tree
