"""Train, federated, prefill and decode steps of the LMs (counterpart of
repro.launch.steps): the decoder-only families (`lm.loss_fn`) and the
whisper encoder-decoder (`encdec.loss_fn`, its prefill encoding the
frames and its decode steps taking the encoder states).

The reference's steps take the parameter pytree as their first argument;
here the parameters live in the `LM` module, which takes its place, and
a train step updates them in place. The spec builders (`param_structs`,
`param_specs`, `batch_structs`, `cache_structs`, `build`) give the same
per-device layout as the reference's through `launch/sharding.py`, on
meta tensors of the global shape: `build` returns the step, run under
`act_sharding.use_mesh`, and its example inputs, a meta model standing
for the parameter tree (launch/dryrun.py runs it once).

The paper's technique enters through the federated step: one LM per
agent, each on its agent mesh member's device, trained by the
generalized DEC-apx-GP update (core/federated.py, eq. 34).
"""
from __future__ import annotations

import torch

from ..core import federated
from ..models import build_model, encdec, lm
from ..models.act_sharding import constrain, use_mesh
from ..models.convert import _leaf_index
from ..optim import adafactor, adam
from . import sharding as shd

SHAPES = {
    "train_4k": dict(kind="train", seq=4_096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32_768, batch=32),
    "decode_32k": dict(kind="decode", seq=32_768, batch=128),
    "long_500k": dict(kind="decode", seq=524_288, batch=1, long=True),
}

# long_500k gate: sub-quadratic archs run as-is; dense archs run the
# sliding-window variant; whisper (enc-dec audio) skips.
LONG_OK_NATIVE = {"jamba-v0.1-52b", "xlstm-350m"}
LONG_SKIP = {"whisper-small"}
LONG_WINDOW = 8_192

# gradient-accumulation factor for train_4k in the reference's pod
# deployment (its saved-residual memory control)
MICROBATCH = {
    "dbrx-132b": 8,
    "llama4-maverick-400b-a17b": 8,
    "internvl2-76b": 16,
    "jamba-v0.1-52b": 4,
    "granite-3-8b": 4,
    "phi3-medium-14b": 4,
    "chatglm3-6b": 2,
    "whisper-small": 8,
}


def shape_supported(cfg, shape_name: str) -> bool:
    if shape_name == "long_500k" and cfg.name in LONG_SKIP:
        return False
    return True


def cfg_for_shape(cfg, shape_name: str):
    """Per-shape config adjustments (window variant, remat for training)."""
    if shape_name == "train_4k":
        cfg = cfg.with_overrides(remat=True)
    if shape_name == "long_500k" and cfg.name not in LONG_OK_NATIVE:
        cfg = cfg.with_overrides(window=LONG_WINDOW)
    if cfg.encdec and shape_name in ("decode_32k", "long_500k", "prefill_32k"):
        seq = SHAPES[shape_name]["seq"]
        if cfg.max_seq < seq + 1:
            cfg = cfg.with_overrides(max_seq=seq + 1)
    return cfg


def pick_optimizer(cfg, lr=1e-4):
    """(optimizer, name): Adafactor for llama4 (its float32 Adam state
    does not fit the reference's pod), Adam otherwise."""
    if cfg.name.startswith("llama4"):
        return adafactor(lr), "adafactor"
    return adam(lr), "adam"


def _detached(metrics):
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg, optimizer, microbatch: int = 1):
    """train_step(model, opt_state, batch, attention=None) -> (opt_state,
    loss, metrics): the gradient of the family's loss (`lm.loss_fn`, or
    `encdec.loss_fn` for an encoder-decoder) over the model's
    parameters, `optimizer`'s update applied to them in place.

    microbatch > 1 accumulates the gradient over that many equal slices
    of the batch in float32 (each slice's gradient / microbatch), as the
    reference's scan does; the loss is then the slices' mean and metrics
    are {}; each batch tensor is split as (microbatch, B / microbatch,
    ...) and its slices pinned to the batch axes (`constrain`), as the
    reference's scan takes them. `attention` replaces ops.flash_attention
    in every layer."""
    loss_fn = encdec.loss_fn if cfg.encdec else lm.loss_fn

    def train_step(model, opt_state, batch, attention=None):
        params = dict(model.named_parameters())
        model.zero_grad(set_to_none=True)
        if microbatch == 1:
            loss, metrics = loss_fn(cfg, model, batch, attention=attention)
            loss.backward()
            grads = {n: p.grad for n, p in params.items()}
            loss, metrics = loss.detach(), _detached(metrics)
        else:
            B = batch["tokens"].shape[0]
            if B % microbatch:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"microbatch {microbatch}")
            split = {k: constrain(v.reshape((microbatch, B // microbatch)
                                            + v.shape[1:]),
                                  (None, "batch") + (None,) * (v.dim() - 1))
                     for k, v in batch.items()}
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.items()}
            losses = []
            for i in range(microbatch):
                part = {k: v[i] for k, v in split.items()}
                model.zero_grad(set_to_none=True)
                li, _ = loss_fn(cfg, model, part, attention=attention)
                li.backward()
                with torch.no_grad():
                    for n, p in params.items():
                        grads[n] += p.grad.to(torch.float32) / microbatch
                losses.append(li.detach())
            loss, metrics = torch.stack(losses).mean(), {}
        model.zero_grad(set_to_none=True)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, params)
            del grads
            for n, p in params.items():
                p.add_(updates[n])
        return opt_state, loss, metrics

    return train_step


def make_federated_train_step(cfg, *, n_agents: int, rho: float = 1.0,
                              kappa: float = 10.0, exchange: bool = True):
    """step(models, duals, batches, attention=None) -> (duals, loss): one
    generalized DEC-apx-GP round (eq. 34) over `n_agents` agents.

    models: one LM per agent, each on its agent mesh member's device (its
    parameters are the agent's opinion theta_i, updated in place); duals:
    one dict name -> tensor per agent (`federated.dec_admm_init`), updated
    in place and returned; batches: one batch dict per agent on its
    device. Each agent's local gradient stays on its device; the update
    exchanges parameters with the ring neighbours only
    (`federated.dec_admm_leaf`, the reference's eq. 34a/b; a one-agent
    ring is its own neighbour, as the reference's roll of a length-1
    axis). loss is the agents' mean loss, on the first agent's device.

    exchange=False is the local-only variant: no messages and no dual
    update, theta_i -= g_i / (kappa + 2 |N| rho), the same step size."""
    loss_fn = encdec.loss_fn if cfg.encdec else lm.loss_fn
    deg = 2.0 if n_agents > 2 else 1.0

    def step(models, duals, batches, attention=None):
        if not len(models) == len(duals) == len(batches) == n_agents:
            raise ValueError(f"want {n_agents} models, duals and batches, "
                             f"got {len(models)}, {len(duals)}, "
                             f"{len(batches)}")
        losses = []
        for model, batch in zip(models, batches):
            model.zero_grad(set_to_none=True)
            loss = loss_fn(cfg, model, batch, attention=attention)[0]
            loss.backward()
            losses.append(loss.detach())
        params = [dict(m.named_parameters()) for m in models]
        with torch.no_grad():
            for key in params[0]:
                ths = [p[key] for p in params]
                gs = [p[key].grad.to(p[key].dtype) for p in params]
                if exchange:
                    nbr, d = ((ths, 1.0) if n_agents == 1
                              else federated.neighbor_sum(ths))
                    new = [federated.dec_admm_leaf(th, du[key], g, s, d, rho,
                                                   kappa)
                           for th, du, g, s in zip(ths, duals, gs, nbr)]
                    del nbr
                else:
                    step_size = kappa + 2.0 * deg * rho
                    new = [((th - g / step_size).to(th.dtype), du[key])
                           for th, du, g in zip(ths, duals, gs)]
                for th, du, (th_next, p_next) in zip(ths, duals, new):
                    th.copy_(th_next)
                    if exchange:
                        du[key].copy_(p_next)
                del new, gs
            for model in models:
                model.zero_grad(set_to_none=True)
        dev = losses[0].device
        return duals, torch.stack([l.to(dev) for l in losses]).mean()

    return step


def make_prefill_step(cfg, max_len: int):
    """A fresh cache of `max_len` positions filled with the prompt, and the
    logits of the prompt's last position (B, 1, V):

      decoder-only     prefill(model, tokens (B, P), embeds=None,
                       attention=None) -> (logits, cache), `embeds` the
                       VLM's patch prefix (B, vis_tokens, d);
      encoder-decoder  prefill(model, frames (B, enc_seq, d), tokens,
                       attention=None) -> (logits, cache, enc_out).

    `attention` replaces ops.flash_attention in every layer."""
    if cfg.encdec:
        @torch.no_grad()
        def prefill_encdec(model, frames, tokens, attention=None):
            enc_out = model.encode(frames, attention)
            cache = model.init_decode_cache(tokens.shape[0], max_len)
            logits, cache = model.decode(tokens, enc_out, cache=cache,
                                         logits_slice=1, attention=attention)
            return logits, cache, enc_out
        return prefill_encdec

    @torch.no_grad()
    def prefill(model, tokens, embeds=None, attention=None):
        cache = model.init_decode_cache(tokens.shape[0], max_len)
        logits, _, cache = model(tokens, cache=cache, logits_slice=1,
                                 attention=attention, embeds=embeds)
        return logits, cache
    return prefill


def make_decode_step(cfg):
    """decode(model, cache, tokens (B, 1)) -> (logits (B, 1, V), cache);
    for an encoder-decoder decode(model, cache, enc_out, tokens,
    attention=None), `attention` replacing ops.flash_attention in the
    cross-attention (which runs the kernel at Sq = 1 against every
    frame)."""
    if cfg.encdec:
        @torch.no_grad()
        def decode_encdec(model, cache, enc_out, tokens, attention=None):
            return model.decode(tokens, enc_out, cache=cache,
                                attention=attention)
        return decode_encdec

    @torch.no_grad()
    def decode(model, cache, tokens):
        logits, _, cache = model(tokens, cache=cache)
        return logits, cache
    return decode


# ---------------------------------------------------------------------------
# input specs (meta tensors of the global shape, tagged with their
# sharding: nothing is allocated)
# ---------------------------------------------------------------------------

def param_structs(cfg, dtype=torch.bfloat16):
    """(a model of `cfg` on meta in `dtype`, {parameter name: logical
    axes})."""
    model = build_model(cfg, device="meta", dtype=dtype, init=False)
    return model, lm.param_axes(model)


def model_param_specs(model, mesh, policy=None) -> dict:
    """{parameter name: PartitionSpec} of `model` on `mesh`: each is the
    reference leaf's spec (`models.convert`'s index names the leaf and its
    stacking axes, which no rule shards) with the stacking entries
    dropped."""
    axes, index = lm.param_axes(model), _leaf_index(model)
    specs = {}
    for name, p in model.named_parameters():
        n = len(index[name][1])
        spec = shd.spec_for_axes(mesh, ("layers",) * n + axes[name],
                                 (1,) * n + tuple(p.shape), policy=policy)
        assert spec[:n] == (None,) * n, (name, spec)
        specs[name] = shd.P(*spec[n:])
    return specs


def param_specs(cfg, mesh, dtype=torch.bfloat16, policy=None):
    """(meta model, {parameter name: PartitionSpec})."""
    model, _ = param_structs(cfg, dtype)
    return model, model_param_specs(model, mesh, policy)


def batch_structs(cfg, shape_name: str, dtype=torch.bfloat16):
    """(shapes, logical_axes) for the train/prefill token batch: meta
    tensors, tokens and labels int32 as the reference's."""
    info = SHAPES[shape_name]
    B, S = info["batch"], info["seq"]

    def sds(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    i32 = torch.int32
    tok_ax = ("batch", "seq")
    if cfg.encdec:
        shapes = {"frames": sds((B, cfg.enc_seq, cfg.d_model), dtype),
                  "tokens": sds((B, S), i32), "labels": sds((B, S), i32)}
        axes = {"frames": ("batch", "enc_seq_act", "embed_act"),
                "tokens": tok_ax, "labels": tok_ax}
    elif cfg.vis_tokens:
        s_text = S - cfg.vis_tokens
        shapes = {"tokens": sds((B, s_text), i32),
                  "labels": sds((B, s_text), i32),
                  "embeds": sds((B, cfg.vis_tokens, cfg.d_model), dtype)}
        axes = {"tokens": tok_ax, "labels": tok_ax,
                "embeds": ("batch", "vis_act", "embed_act")}
    else:
        shapes = {"tokens": sds((B, S), i32), "labels": sds((B, S), i32)}
        axes = {"tokens": tok_ax, "labels": tok_ax}
    return shapes, axes


def cache_structs(cfg, batch: int, max_len: int, dtype=torch.bfloat16):
    """(a decode cache of `cfg` on meta, its logical axes)."""
    mod = encdec if cfg.encdec else lm
    return (mod.init_decode_cache(cfg, batch, max_len, dtype, "meta"),
            mod.cache_axes(cfg))


def build(cfg, shape_name: str, mesh, dtype=torch.bfloat16, lr=1e-4,
          policy=None):
    """(step, example inputs, cfg) for one (arch, shape) on `mesh`: the
    inputs are meta tensors of the global shape tagged with their
    sharding (`shd.with_sharding`), the parameters a meta model's; the
    step runs under `use_mesh(mesh)`, as the reference's.

    step signatures:
      train  : (model, opt_state, batch)
      prefill: (model, [frames,] tokens[, embeds])
      decode : (model, cache, [enc_out,] tokens)
    """
    cfg = cfg_for_shape(cfg, shape_name)
    info = SHAPES[shape_name]
    kind = info["kind"]
    B, S = info["batch"], info["seq"]
    shard_seq = kind == "decode"   # cache-sequence sharding (sharding.py)

    def _meshed(fn):
        def wrapped(*a, **kw):
            with use_mesh(mesh, shard_kv_seq=shard_seq, policy=policy):
                return fn(*a, **kw)
        return wrapped

    model, p_specs = param_specs(cfg, mesh, dtype, policy=policy)
    params = dict(model.named_parameters())
    shd.with_sharding(mesh, params, p_specs)

    if kind == "train":
        optimizer, opt_name = pick_optimizer(cfg, lr)
        step = _meshed(make_train_step(cfg, optimizer,
                                       microbatch=MICROBATCH.get(cfg.name, 1)))
        if opt_name == "adam":
            opt_specs = shd.adam_state_specs(p_specs)
        else:
            opt_specs = shd.adafactor_state_specs(p_specs, params)
        opt_in = shd.with_sharding(mesh, optimizer.init(params), opt_specs)
        b_shapes, b_axes = batch_structs(cfg, shape_name, dtype)
        b_specs = shd.tree_specs(mesh, b_axes, b_shapes, policy=policy)
        batch_in = shd.with_sharding(mesh, b_shapes, b_specs)
        return step, (model, opt_in, batch_in), cfg

    if kind == "prefill":
        step = _meshed(make_prefill_step(cfg, max_len=S + 1))
        b_shapes, b_axes = batch_structs(cfg, shape_name, dtype)
        b_specs = shd.tree_specs(mesh, b_axes, b_shapes, policy=policy)
        b_in = shd.with_sharding(mesh, b_shapes, b_specs)
        if cfg.encdec:
            return step, (model, b_in["frames"], b_in["tokens"]), cfg
        if cfg.vis_tokens:
            return step, (model, b_in["tokens"], b_in["embeds"]), cfg
        return step, (model, b_in["tokens"]), cfg

    # decode: one new token against a cache of S entries; the token's and
    # the encoder states' specs take the default rules, as the reference's
    step = _meshed(make_decode_step(cfg))
    c_shapes, c_axes = cache_structs(cfg, B, S, dtype)
    c_specs = shd.tree_specs(mesh, c_axes, c_shapes, shard_kv_seq=shard_seq,
                             policy=policy)
    cache_in = shd.with_sharding(mesh, c_shapes, c_specs)
    tok = shd.with_sharding(
        mesh, torch.empty((B, 1), dtype=torch.int32, device="meta"),
        shd.spec_for_axes(mesh, ("batch", "seq"), (B, 1)))
    if cfg.encdec:
        enc_shape = (B, cfg.enc_seq, cfg.d_model)
        enc_in = shd.with_sharding(
            mesh, torch.empty(enc_shape, dtype=dtype, device="meta"),
            shd.spec_for_axes(mesh, ("batch", "enc_seq_act", "embed_act"),
                              enc_shape))
        return step, (model, cache_in, enc_in, tok), cfg
    return step, (model, cache_in, tok), cfg
