"""Decoder-only language model, dense transformer family (counterpart of
repro.models.lm).

    model = LM(cfg, device=..., generator=torch.Generator().manual_seed(0))
    logits, aux, cache = model(tokens, cache=..., logits_slice=1)
    loss, aux = loss_fn(cfg, model, batch)

The reference stacks its layers for `jax.lax.scan` (parameters carry
leading (n_groups, 1) axes); here they are an `nn.ModuleList` of blocks,
one per layer, and models/convert.py maps one layout onto the other.
Each block is pre-norm: x + attn(rmsnorm(x)), then x + mlp(rmsnorm(x)).

With `cfg.remat` a training forward (grad mode on, no cache) runs each
block under `torch.utils.checkpoint` (non-reentrant), as the reference
wraps each layer group in `jax.checkpoint`: the block's activations are
recomputed in the backward, its attention kernel launched again.
`remat_policy="dots"` keeps the outputs of the unbatched matrix products
(the reference's `dots_with_no_batch_dims_saveable`) and recomputes the
rest.

Not yet ported: the MoE FFN, the jamba and xLSTM block families, the
whisper encoder-decoder and the VLM patch prefix (ROADMAP A11c).
`act_sharding.constrain` is a no-op without a mesh in the reference and
belongs to the multi-GPU work (ROADMAP A7b).
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from ..device import resolve_device
from .attention import Attention, init_cache
from .common import RMSNorm, cross_entropy, gelu_mlp, init_scale, swiglu

NOT_PORTED = "not yet ported (ROADMAP A11c)"


def check_supported(cfg) -> None:
    """Raise NotImplementedError for a family the port does not run yet."""
    if cfg.encdec:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder LM is "
                                  f"{NOT_PORTED}")
    if cfg.block_type != "transformer":
        raise NotImplementedError(f"{cfg.name}: {cfg.block_type} blocks are "
                                  f"{NOT_PORTED}")
    if cfg.num_experts:
        raise NotImplementedError(f"{cfg.name}: the MoE FFN is {NOT_PORTED}")
    if cfg.vis_tokens:
        raise NotImplementedError(f"{cfg.name}: the VLM patch prefix is "
                                  f"{NOT_PORTED}")


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


class Block(nn.Module):
    """One dense transformer layer: ln1, attn, ln2, mlp."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.mlp = MLP(cfg, dtype, device)

    def forward(self, x, positions, cache=None, attention=None):
        h, new_cache = self.attn(self.ln1(x), positions, cache,
                                 attention=attention)
        x = x + h
        return x + self.mlp(self.ln2(x)), new_cache


class LM(nn.Module):
    """Dense decoder-only LM: embed, blocks, final_norm, lm_head (untied
    unless cfg.tie_embeddings).

    Runs on `cuda` unless `device` says otherwise (`resolve_device`).
    Parameters are drawn from `generator` (a torch.Generator on `device`,
    or None for torch's default) with the reference's initial scales:
    normal with standard deviation 0.02 for the embedding, 1 / sqrt(fan_in)
    for the projections (fan_in the parameter's first axis), ones for the
    norms. `init=False` leaves them uninitialized, for a caller that loads
    them (models/convert.py)."""

    def __init__(self, cfg, device=None, dtype=torch.float32,
                 generator=None, init: bool = True):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        d, V = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(torch.empty((V, d), dtype=dtype,
                                              device=device))
        self.blocks = nn.ModuleList(Block(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
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
            blk.attn.reset_parameters(generator)
            blk.mlp.reset_parameters(generator)
        if self.lm_head is not None:
            self.lm_head.normal_(0.0, init_scale("normal", self.cfg.d_model),
                                 generator=generator)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens, cache=None, positions=None,
                logits_slice: int = 0, attention=None):
        """tokens (B, S) int -> (logits (B, S or logits_slice, V), aux, cache).

        cache: `init_decode_cache` for autoregressive decode; its per-layer
        k/v are written in place and the returned cache carries index + S.
        aux is the reference's MoE auxiliary loss, 0 for a dense model.
        `attention` replaces ops.flash_attention in every layer (same
        signature). With `cfg.remat`, grad mode on and no cache, each
        block runs under activation checkpointing."""
        x = self.embed[tokens]
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
        new_layers = []
        for blk, layer_cache in zip(self.blocks, layers):
            if remat:
                x, c = _ckpt.checkpoint(blk, x, positions, None, attention,
                                        use_reentrant=False,
                                        context_fn=context_fn)
            else:
                x, c = blk(x, positions, layer_cache, attention)
            new_layers.append(c)
        x = self.final_norm(x)
        if logits_slice:
            x = x[:, -logits_slice:]
        head = self.embed.T if self.lm_head is None else self.lm_head
        logits = x @ head
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new_cache = ({"layers": new_layers, "index": cache["index"] + S}
                     if cache is not None else None)
        return logits, aux, new_cache

    def init_decode_cache(self, batch: int, max_len: int):
        """Zeroed per-layer k/v caches (B, max_len, KH, hd) in the
        parameters' dtype, and index 0."""
        return {"layers": [init_cache(self.cfg, batch, max_len,
                                      self.embed.dtype, self.device)
                           for _ in self.blocks],
                "index": 0}


def loss_fn(cfg, model, batch, aux_weight: float = 0.01, attention=None):
    """(loss, {"ce", "aux"}) of `model` on batch = dict(tokens (B, S),
    labels (B, S)); labels < 0 are ignored. Counterpart of the reference's
    `lm.loss_fn(cfg, params, batch)`, the module standing where the
    parameters stand (its own cfg decides the remat, as the reference's
    `cfg` does); `attention` replaces ops.flash_attention in every layer,
    as in `LM.forward`. The VLM prefix is not yet ported (A11c)."""
    check_supported(cfg)
    logits, aux, _ = model(batch["tokens"], attention=attention)
    ce = cross_entropy(logits, batch["labels"])
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def param_count(cfg) -> int:
    """Parameters of the dense LM of `cfg`."""
    d, H, KH, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    mlp = (3 if cfg.mlp_act == "swiglu" else 2) * d * cfg.d_ff
    layer = 2 * d + d * hd * (2 * H + 2 * KH) + mlp
    head = 0 if cfg.tie_embeddings else d * cfg.vocab_size
    return cfg.vocab_size * d + cfg.num_layers * layer + d + head
