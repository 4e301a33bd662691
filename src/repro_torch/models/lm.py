"""Decoder-only language model: the dense and MoE transformer, the jamba
hybrid and the VLM patch prefix (counterpart of repro.models.lm).

    model = LM(cfg, device=..., generator=torch.Generator().manual_seed(0))
    logits, aux, cache = model(tokens, embeds=..., cache=..., logits_slice=1)
    loss, aux = loss_fn(cfg, model, batch)

The reference stacks its layers for `jax.lax.scan`; here they are one
`nn.ModuleList` of blocks in the order the reference runs them, and
`layer_plan(cfg)` says where each block sits in the reference's stacked
tree (models/convert.py maps one layout onto the other):

  transformer   groups of `moe_every` layers (1 without experts): k - 1
                dense layers, then one MoE layer (`blocks.dense` stacked
                (n_groups, k - 1), `blocks.moe` (n_groups,)); a dense
                model is groups of one dense layer.
  jamba         superblocks of `attention_every` layers: one attention
                layer with a dense MLP, then n_moe mamba + MoE layers,
                then the remaining mamba layers (`_jamba_split`). This is
                the reference's composition order, not Jamba's published
                interleave; the layer counts are the same.
  xlstm         groups of `slstm_every` blocks: k - 1 mLSTM blocks, then
                one sLSTM block (`blocks.mlstm` stacked (n_groups, k - 1),
                `blocks.slstm` (n_groups,)).

Each attention block is pre-norm: x + attn(rmsnorm(x)), then x +
ffn(rmsnorm(x)) with the FFN an MLP or an MoE; a mamba block is x +
mamba(rmsnorm(x)), then with an MoE x + moe(rmsnorm(x)); an mLSTM block
is x + mlstm(rmsnorm(x)) with no FFN, an sLSTM block x + slstm(rmsnorm(x))
then x + gelu_mlp(rmsnorm(x)). `embeds` (B, P, d), the VLM's patch
embeddings, go before the token embeddings, and positions run over the
whole stream; `loss_fn` pads their labels with -1. A decode cache holds
k/v for every attention layer, {conv, h} for every mamba layer, {C, n, m}
for every mLSTM and {h, c, n, m} for every sLSTM (no KV cache, so an
xLSTM's state does not grow with `max_len`), and one index over prefix
and prompt. Each group starts by pinning the residual stream to the
batch axes (`act_sharding.constrain`, a no-op without a mesh).

With `cfg.remat` a training forward (grad mode on, no cache) runs each
block under `torch.utils.checkpoint` (non-reentrant), as the reference
wraps each layer group in `jax.checkpoint`: the block's activations are
recomputed in the backward, its attention kernel launched again.
`remat_policy="dots"` keeps the outputs of the unbatched matrix products
(the reference's `dots_with_no_batch_dims_saveable`) and recomputes the
rest.

The whisper encoder-decoder is models/encdec.py's `EncDec`. Each module
names its parameters' logical axes in the reference's words (`AXES`,
`param_axes`), which launch/sharding.py maps to mesh axes.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from ..device import resolve_device
from .act_sharding import constrain
from .attention import Attention, init_cache
from .common import RMSNorm, cross_entropy, gelu_mlp, init_scale, swiglu
from .mamba import Mamba, init_mamba_state
from .moe import MoE
from .xlstm import MLSTM, SLSTM, init_mlstm_state, init_slstm_state


def _jamba_split(cfg):
    """(n_groups, n_moe_mamba, n_dense_mamba) per superblock."""
    k = cfg.attention_every
    n_groups = cfg.num_layers // k
    n_mamba = k - 1
    n_moe = (n_mamba + 1) // 2 if cfg.num_experts else 0
    return n_groups, n_moe, n_mamba - n_moe


def layer_plan(cfg) -> list:
    """One (kind, key, group, index) per layer in execution order: kind is
    "attn" (attention + MLP), "attn_moe", "mamba", "mamba_moe", "mlstm" or
    "slstm"; the layer's leaves sit at blocks[key][...][group] of the
    reference's tree, then [index] when the key stacks several layers a
    group (index None when it holds one). Raises ValueError for a block
    type the reference does not know."""
    plan = []
    if cfg.block_type == "xlstm":
        k = cfg.slstm_every
        for g in range(cfg.num_layers // k):
            plan += [("mlstm", "mlstm", g, i) for i in range(k - 1)]
            plan.append(("slstm", "slstm", g, None))
        return plan
    if cfg.block_type not in ("transformer", "jamba"):
        raise ValueError(f"{cfg.name}: unknown block type {cfg.block_type}")
    if cfg.block_type == "transformer":
        if not cfg.num_experts:
            return [("attn", "dense", g, 0) for g in range(cfg.num_layers)]
        k = cfg.moe_every
        for g in range(cfg.num_layers // k):
            plan += [("attn", "dense", g, i) for i in range(k - 1)]
            plan.append(("attn_moe", "moe", g, None))
        return plan
    n_groups, n_moe, n_dense = _jamba_split(cfg)
    for g in range(n_groups):
        plan.append(("attn", "attn", g, None))
        plan += [("mamba_moe", "mamba_moe", g, i) for i in range(n_moe)]
        plan += [("mamba", "mamba_dense", g, i) for i in range(n_dense)]
    return plan


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of `remat_policy="dots"`: save the
    output of a matrix product without batch dimensions (a plain `mm`, or
    the one-batch `bmm` that einsum makes of "bsd,dhk->bshk"), recompute
    everything else."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


class MLP(nn.Module):
    """SwiGLU (wg, wu, wd) or GELU (w1, w2) feed-forward."""

    AXES = {"wg": ("embed", "ffn"), "wu": ("embed", "ffn"),
            "wd": ("ffn", "embed_out"), "w1": ("embed", "ffn"),
            "w2": ("ffn", "embed_out")}

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        self.act = cfg.mlp_act
        d, f = cfg.d_model, cfg.d_ff
        shapes = ({"wg": (d, f), "wu": (d, f), "wd": (f, d)}
                  if self.act == "swiglu" else {"w1": (d, f), "w2": (f, d)})
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device)))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        for w in self.parameters():
            w.normal_(0.0, init_scale("normal", w.shape[0]),
                      generator=generator)

    def forward(self, x):
        if self.act == "swiglu":
            return swiglu(x, self.wg, self.wu, self.wd)
        return gelu_mlp(x, self.w1, self.w2)


def _zero_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


class Block(nn.Module):
    """One attention layer: ln1, attn, ln2, then mlp or (moe=True) moe."""

    def __init__(self, cfg, dtype=torch.float32, device=None,
                 moe: bool = False):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        if moe:
            self.moe = MoE(cfg, dtype, device)
        else:
            self.mlp = MLP(cfg, dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.attn.reset_parameters(generator)
        (self.moe if hasattr(self, "moe") else self.mlp) \
            .reset_parameters(generator)

    def forward(self, x, positions, cache=None, attention=None):
        """Returns (x, new_cache, aux)."""
        h, new_cache = self.attn(self.ln1(x), positions, cache,
                                 attention=attention)
        x = x + h
        y = self.ln2(x)
        if hasattr(self, "moe"):
            out, aux = self.moe(y)
        else:
            out, aux = self.mlp(y), _zero_aux(x)
        return x + out, new_cache, aux


class MambaBlock(nn.Module):
    """One mamba layer: ln1, mamba, and with moe=True ln2, moe."""

    def __init__(self, cfg, dtype=torch.float32, device=None,
                 moe: bool = False):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.mamba = Mamba(cfg, dtype, device)
        if moe:
            self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
            self.moe = MoE(cfg, dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.mamba.reset_parameters(generator)
        if hasattr(self, "moe"):
            self.moe.reset_parameters(generator)

    def forward(self, x, positions=None, state=None, attention=None):
        """Returns (x, new_state, aux); positions and attention are not
        used (the signature is Block's)."""
        h, new_state = self.mamba(self.ln1(x), state)
        x = x + h
        if hasattr(self, "moe"):
            out, aux = self.moe(self.ln2(x))
            return x + out, new_state, aux
        return x, new_state, _zero_aux(x)


class MLSTMBlock(nn.Module):
    """One mLSTM block: ln, cell (no FFN)."""

    def __init__(self, cfg, dtype=torch.float32, device=None,
                 moe: bool = False):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.cell = MLSTM(cfg, dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.cell.reset_parameters(generator)

    def forward(self, x, positions=None, state=None, attention=None):
        """Returns (x, new_state, aux 0); positions and attention are not
        used (the signature is Block's)."""
        h, new_state = self.cell(self.ln(x), state)
        return x + h, new_state, _zero_aux(x)


class SLSTMBlock(nn.Module):
    """One sLSTM block: ln, cell, then ln2 and the (GELU) mlp."""

    def __init__(self, cfg, dtype=torch.float32, device=None,
                 moe: bool = False):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.cell = SLSTM(cfg, dtype, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.mlp = MLP(cfg, dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.cell.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def forward(self, x, positions=None, state=None, attention=None):
        """Returns (x, new_state, aux 0), as MLSTMBlock's."""
        h, new_state = self.cell(self.ln(x), state)
        x = x + h
        return x + self.mlp(self.ln2(x)), new_state, _zero_aux(x)


_BLOCKS = {"attn": (Block, False), "attn_moe": (Block, True),
           "mamba": (MambaBlock, False), "mamba_moe": (MambaBlock, True),
           "mlstm": (MLSTMBlock, False), "slstm": (SLSTMBlock, False)}


def param_axes(model) -> dict:
    """{parameter name: its logical axes}, in the reference's words, from
    each module's `AXES` (a norm's weight is ("embed_norm",))."""
    out = {}
    for prefix, mod in model.named_modules():
        axes = getattr(mod, "AXES", {})
        for name, _ in mod.named_parameters(recurse=False):
            out[f"{prefix}.{name}" if prefix else name] = axes[name]
    return out


class LM(nn.Module):
    """Decoder-only LM: embed, blocks, final_norm, lm_head (untied unless
    cfg.tie_embeddings).

    Runs on `cuda` unless `device` says otherwise (`resolve_device`).
    Parameters are drawn from `generator` (a torch.Generator on `device`,
    or None for torch's default) with the reference's initializers:
    normal with standard deviation 0.02 for the embedding, the router and
    A_log, 1 / sqrt(fan_in) for the projections (fan_in the axis the
    reference's ParamDef names), ones for the norms and D, zeros for the
    mamba biases. `init=False` leaves them uninitialized, for a caller
    that loads them (models/convert.py) or a dry run on `meta`."""

    AXES = {"embed": ("vocab", "embed"), "lm_head": ("embed", "vocab")}

    def __init__(self, cfg, device=None, dtype=torch.float32,
                 generator=None, init: bool = True):
        super().__init__()
        if cfg.encdec:
            raise ValueError(f"{cfg.name} is an encoder-decoder: build it "
                             f"with models.EncDec (models.build_model)")
        self.plan = layer_plan(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        d, V = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(torch.empty((V, d), dtype=dtype,
                                              device=device))
        self.blocks = nn.ModuleList()
        for kind, *_ in self.plan:
            cls, moe = _BLOCKS[kind]
            self.blocks.append(cls(cfg, dtype, device, moe=moe))
        self.final_norm = RMSNorm(d, cfg.norm_eps, dtype, device)
        self.lm_head = (None if cfg.tie_embeddings else nn.Parameter(
            torch.empty((d, V), dtype=dtype, device=device)))
        if init:
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.embed.normal_(0.0, init_scale("small_normal", 0),
                           generator=generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        if self.lm_head is not None:
            self.lm_head.normal_(0.0, init_scale("normal", self.cfg.d_model),
                                 generator=generator)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens, cache=None, positions=None,
                logits_slice: int = 0, attention=None, embeds=None):
        """tokens (B, S) int -> (logits (B, P + S or logits_slice, V), aux,
        cache).

        embeds (B, P, d): the VLM's patch prefix, placed before the
        tokens. cache: `init_decode_cache` for autoregressive decode; its
        attention layers' k/v are written in place, its mamba states
        replaced, and the returned cache carries index + P + S. aux is the
        MoE layers' auxiliary loss summed (float32; 0 without experts).
        `attention` replaces ops.flash_attention in every layer (same
        signature). With `cfg.remat`, grad mode on and no cache, each
        block runs under activation checkpointing."""
        x = self.embed[tokens]
        if embeds is not None:
            x = torch.cat([embeds.to(x.dtype), x], dim=1)
        B, S, _ = x.shape
        if positions is None:
            start = cache["index"] if cache is not None else 0
            positions = (start + torch.arange(S, device=x.device)) \
                .expand(B, S)
        layers = cache["layers"] if cache is not None else \
            [None] * len(self.blocks)
        remat = (self.cfg.remat_policy if self.cfg.remat and cache is None
                 and torch.is_grad_enabled() else None)
        context_fn = (functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _dots_policy)
            if remat == "dots" else _ckpt.noop_context_fn)
        aux = _zero_aux(x)
        new_layers = []
        group = None
        for blk, layer_cache, (_, _, g, _) in zip(self.blocks, layers,
                                                  self.plan):
            if g != group:             # pin the residual stream, a group
                x = constrain(x, ("batch", None, None))
                group = g
            if remat:
                x, c, a = _ckpt.checkpoint(blk, x, positions, None,
                                           attention, use_reentrant=False,
                                           context_fn=context_fn)
            else:
                x, c, a = blk(x, positions, layer_cache, attention)
            aux = aux + a
            new_layers.append(c)
        x = self.final_norm(x)
        if logits_slice:
            x = x[:, -logits_slice:]
        head = self.embed.T if self.lm_head is None else self.lm_head
        logits = x @ head
        new_cache = ({"layers": new_layers, "index": cache["index"] + S}
                     if cache is not None else None)
        return logits, aux, new_cache

    def init_decode_cache(self, batch: int, max_len: int):
        """`init_decode_cache(cfg, ...)` in the parameters' dtype, on their
        device."""
        return init_decode_cache(self.cfg, batch, max_len, self.embed.dtype,
                                 self.device)


def init_decode_cache(cfg, batch: int, max_len: int, dtype=torch.float32,
                      device=None):
    """Zeroed decode state, index 0, one entry a layer of `layer_plan`:
    k/v (B, max_len, KH, hd) in `dtype` for an attention layer, conv
    (B, dc - 1, di) in `dtype` and h (B, di, ds) float32 for a mamba
    layer, {C, n, m} float32 for an mLSTM and {h, c, n, m} for an sLSTM."""
    init = {"attn": lambda: init_cache(cfg, batch, max_len, dtype, device),
            "mamba": lambda: init_mamba_state(cfg, batch, dtype, device),
            "mlstm": lambda: init_mlstm_state(cfg, batch, device),
            "slstm": lambda: init_slstm_state(cfg, batch, device)}
    return {"layers": [init[kind.split("_")[0]]()
                       for kind, *_ in layer_plan(cfg)], "index": 0}


#: logical axes of each state of a decode cache (launch/sharding.py)
CACHE_AXES = {
    "attn": {"k": ("batch", "kv_seq", "kv_heads", "head_dim"),
             "v": ("batch", "kv_seq", "kv_heads", "head_dim"),
             "index": ()},
    "mamba": {"conv": ("batch", "conv_k", "mamba_inner"),
              "h": ("batch", "mamba_inner", "mamba_state")},
    "mlstm": {"C": ("batch", "heads", "head_dim", "head_dim_r"),
              "n": ("batch", "heads", "head_dim"),
              "m": ("batch", "heads")},
    "slstm": {k: ("batch", "heads", "head_dim") for k in "hcnm"}}


def cache_axes(cfg) -> dict:
    """Logical axes mirroring `init_decode_cache` (the reference's
    `cache_axes` without its stacking "layers" axes): one dict a layer,
    and () for every index, the cache's and each attention layer's."""
    return {"layers": [CACHE_AXES[kind.split("_")[0]]
                       for kind, *_ in layer_plan(cfg)], "index": ()}


def loss_fn(cfg, model, batch, aux_weight: float = 0.01, attention=None):
    """(loss, {"ce", "aux"}) of `model` on batch = dict(tokens (B, S),
    labels (B, S), [embeds (B, P, d)]); labels < 0 are ignored, and the
    patch prefix's positions get label -1. Counterpart of the
    reference's `lm.loss_fn(cfg, params, batch)`, the module standing
    where the parameters stand (its own cfg decides the remat, as the
    reference's `cfg` does); `attention` replaces ops.flash_attention in
    every layer, as in `LM.forward`."""
    embeds = batch.get("embeds")
    logits, aux, _ = model(batch["tokens"], attention=attention,
                           embeds=embeds)
    labels = batch["labels"]
    if embeds is not None:
        pad = torch.full(embeds.shape[:2], -1, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    ce = cross_entropy(logits, labels)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def _sizes(cfg) -> dict:
    """Parameters of one layer of each kind and of the norms' vector."""
    d, H, KH, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    attn = d * hd * (2 * H + 2 * KH)
    mlp = (3 if cfg.mlp_act == "swiglu" else 2) * d * cfg.d_ff
    moe = d * cfg.num_experts + 3 * cfg.num_experts * d * cfg.d_ff
    di, ds, dc = cfg.d_inner_mamba, cfg.mamba_d_state, cfg.mamba_d_conv
    dtr = max(d // 16, 1)
    mamba = (d * 2 * di + dc * di + di + di * (dtr + 2 * ds) + dtr * di
             + di + di * ds + di + di * d)
    mlstm = 4 * d * H * hd + 2 * d * H + H * hd * d + H * hd
    slstm = 4 * d * H * hd + 3 * H * hd * hd + H * hd * d
    return {"attn": 2 * d + attn + mlp, "attn_moe": 2 * d + attn + moe,
            "mamba": d + mamba, "mamba_moe": 2 * d + mamba + moe,
            "mlstm": d + mlstm, "slstm": 2 * d + slstm + mlp}


def param_count(cfg) -> int:
    """Parameters of the decoder-only LM of `cfg` (every family but the
    encoder-decoder)."""
    sizes = _sizes(cfg)
    head = 0 if cfg.tie_embeddings else cfg.d_model * cfg.vocab_size
    return (cfg.vocab_size * cfg.d_model + sum(
        sizes[kind] for kind, *_ in layer_plan(cfg)) + cfg.d_model + head)
