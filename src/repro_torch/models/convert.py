"""Parameters between the reference's pytree layout and the port's
modules.

The reference keeps its layers stacked for `jax.lax.scan`
(repro/models/lm.py and encdec.py `param_defs`):

    embed (V, d), final_norm (d,), lm_head (d, V) unless tied, and
    dense      blocks/dense/{ln1, attn/{wq, wk, wv, wo}, ln2, mlp/...}
               stacked (n_groups, 1): layer l of the port is group l;
    MoE        blocks/dense/... stacked (n_groups, k - 1) when moe_every
               k > 1, and blocks/moe/{ln1, attn/..., ln2, moe/{router,
               wg, wu, wd}} stacked (n_groups,);
    jamba      blocks/attn/... (n_groups,), blocks/mamba_moe/{ln1,
               mamba/..., ln2, moe/...} (n_groups, n_moe) and
               blocks/mamba_dense/{ln1, mamba/...} (n_groups, n_dense);
    whisper    pos_enc, pos_dec, enc_norm, enc_blocks/{ln1, attn/..., ln2,
               mlp/...} and dec_blocks/{ln1, self_attn/..., ln_x,
               cross_attn/..., ln2, mlp/...}, each stacked (layers,).

`models.lm.layer_plan` says which (key, group, index) each port block
takes. A port parameter's name is its reference path with the block's
list index in place of the stacking axes, and a norm's `.weight` dropped.
Arrays cross as numpy arrays, so this module imports nothing of the
reference.
"""
from __future__ import annotations

import numpy as np
import torch

from .encdec import EncDec
from .lm import LM


def _leaf_index(model) -> dict:
    """{port parameter name: (reference path, stacking index)}."""
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[-1] == "weight":               # an RMSNorm's scale
            parts = parts[:-1]
        if parts[0] == "blocks":
            _, key, g, i = model.plan[int(parts[1])]
            out[name] = (("blocks", key) + tuple(parts[2:]),
                         (g,) if i is None else (g, i))
        elif parts[0] in ("enc_blocks", "dec_blocks"):
            out[name] = ((parts[0],) + tuple(parts[2:]), (int(parts[1]),))
        else:
            out[name] = (tuple(parts), ())
    return out


def _flatten(tree, prefix=()):
    """{path: array} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for key, sub in tree.items():
            out.update(_flatten(sub, prefix + (key,)))
        return out
    return {prefix: np.asarray(tree)}


@torch.no_grad()
def lm_params_from_jax(cfg, tree, device=None):
    """The port's model (`LM`, or `EncDec` for an encoder-decoder cfg)
    holding the reference's parameter tree `tree` (a nested dict of numpy
    arrays, e.g. `jax.tree.map(np.asarray, lm.init_params(...))`), in the
    arrays' dtype, on `device` (default: the card). Raises ValueError when
    a shape differs or the tree has a leaf, or a stacked slice, that the
    model does not take."""
    leaves = _flatten(tree)
    embed = leaves[("embed",)]
    dtype = torch.from_numpy(np.zeros(0, embed.dtype)).dtype
    cls = EncDec if cfg.encdec else LM
    model = cls(cfg, device=device, dtype=dtype, init=False)
    used = {}
    index = _leaf_index(model)
    for name, param in model.named_parameters():
        path, idx = index[name]
        if path not in leaves:
            raise ValueError(f"the tree has no leaf {'/'.join(path)}")
        array = leaves[path][idx] if idx else leaves[path]
        if array.shape != tuple(param.shape):
            raise ValueError(f"{'/'.join(path)}{list(idx)}: parameter shape "
                             f"{array.shape} does not match the port's "
                             f"{tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.array(array)))
        used.setdefault(path, set()).add(idx)
    for path, array in leaves.items():
        n = len(next(iter(used.get(path, {()}))))
        if path not in used or len(used[path]) != int(
                np.prod(array.shape[:n])):
            raise ValueError(f"the tree's leaf {'/'.join(path)} "
                             f"{array.shape} is not the model's layout")
    return model


@torch.no_grad()
def lm_params_to_jax(model) -> dict:
    """The reference's parameter tree of `model`, as numpy arrays."""
    return lm_tree_to_jax(model, dict(model.named_parameters()))


@torch.no_grad()
def lm_tree_to_jax(model, named: dict) -> dict:
    """Per-parameter tensors of `model` in the reference's stacked layout,
    as numpy arrays: `named` maps each name of `model.named_parameters()`
    to a tensor of that parameter's shape (the parameters themselves, a
    gradient, an optimizer's moment), e.g. {n: p.grad for n, p in
    model.named_parameters()} for the tree `jax.grad` gives."""
    params = dict(model.named_parameters())
    if set(named) != set(params):
        raise ValueError(f"want one tensor per parameter of the model; "
                         f"missing {sorted(set(params) - set(named))}"
                         f", unknown {sorted(set(named) - set(params))}")
    stacks = {}
    for name, (path, idx) in _leaf_index(model).items():
        t = named[name]
        if tuple(t.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} is not the "
                             f"parameter's {tuple(params[name].shape)}")
        stacks.setdefault(path, []).append((idx, t.detach().cpu().numpy()))
    tree = {}
    for path, items in stacks.items():
        if items[0][0]:
            lead = tuple(max(idx[a] for idx, _ in items) + 1
                         for a in range(len(items[0][0])))
            leaf = np.zeros(lead + items[0][1].shape, items[0][1].dtype)
            for idx, arr in items:
                leaf[idx] = arr
        else:
            leaf = items[0][1]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree
