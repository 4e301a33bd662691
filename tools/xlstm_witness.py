#!/usr/bin/env python3
"""The float32 conditioning of xlstm-350m at its published widths, on the
CPU: what chip_smoke.py's xLSTM gates are set against.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/xlstm_witness.py \\
        [--parts layer,ragged,model,reference] [--seed 0]

  layer      one mLSTM cell (d 1,024, 4 heads of 256) on 4 x 2,048 unit-RMS
             inputs: the chunked form (8 chunks of 256) against
             mlstm_sequential, h and the final C, n, m, each max |error| /
             max |sequential| (XLSTM_CHUNK_TOL).
  ragged     the same cell's chunk algebra on 2 x 2,049 tokens in float32
             as one chunk (the reference's rule for a length the chunk
             does not divide) and in chunks of 256, each against float64
             chunks of 256: the float32 cost of one long chunk.
  model      the whole model (24 layers, the reference's initial scales
             from --seed) on 1 x 2,048 prompt tokens: prefill + one decode
             step against the parallel forward over the 2,049 tokens
             (chip_smoke.py's gate), the residual stream's max |x| and the
             decode-vs-parallel error after each block, and the parallel
             forward again with the embedding scaled by 1 + 2^-23 (one
             float32 ulp, relative): how far float32 rounding of the
             input alone moves the logits.
  reference  the JAX package's forward over the same 2,049 tokens with the
             same float32 weights (models.convert), against the port's.

Each part prints one JSON line. Errors are relative to the max |value| of
the second operand (max |logit| for logits).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.nn import functional as Fn

from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models import build_model, xlstm
from repro_torch.models.common import rmsnorm

ARCH = "xlstm-350m"


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) / \
        float(b.double().abs().max())


def _cell_inputs(cfg, B, S, seed):
    g = torch.Generator().manual_seed(seed)
    cell = xlstm.MLSTM(cfg, device="cpu")
    cell.reset_parameters(g)
    x = rmsnorm(0.02 * torch.randn(B, S, cfg.d_model, generator=g),
                torch.ones(cfg.d_model))
    q, k, v = (torch.einsum("bsd,dhk->bhsk", x, w)
               for w in (cell.wq, cell.wk, cell.wv))
    lf = Fn.logsigmoid(torch.einsum("bsd,dh->bhs", x, cell.wf))
    li = torch.einsum("bsd,dh->bhs", x, cell.wi)
    return q, k, v, lf, li


def _chunked(cfg, q, k, v, lf, li, L, dtype):
    st = {n: t.to(dtype) for n, t in
          xlstm.init_mlstm_state(cfg, q.shape[0]).items()}
    hs = []
    for c0 in range(0, q.shape[2], L):
        sl = slice(c0, c0 + L)
        h, st = xlstm._mlstm_chunk(*(t[:, :, sl].to(dtype) for t in (q, k, v)),
                                   lf[..., sl].to(dtype),
                                   li[..., sl].to(dtype), st)
        hs.append(h)
    return torch.cat(hs, 2), st


def part_layer(cfg, seed):
    q, k, v, lf, li = _cell_inputs(cfg, 4, 2048, seed)
    h, st = _chunked(cfg, q, k, v, lf, li, cfg.xlstm_chunk, torch.float32)
    hq, sq = xlstm.mlstm_sequential(q, k, v, lf, li,
                                    xlstm.init_mlstm_state(cfg, 4))
    return {"h": _rel(h, hq), **{n: _rel(st[n], sq[n]) for n in "Cnm"}}


def part_ragged(cfg, seed):
    q, k, v, lf, li = _cell_inputs(cfg, 2, 2049, seed)
    want, _ = _chunked(cfg, q, k, v, lf, li, 256, torch.float64)
    one, _ = _chunked(cfg, q, k, v, lf, li, 2049, torch.float32)
    chunks, _ = _chunked(cfg, q, k, v, lf, li, 256, torch.float32)
    return {"cumulative_log_forget_at_2049": float(lf.sum(-1).mean()),
            "one_chunk_f32_vs_f64": _rel(one, want),
            "chunks_of_256_f32_vs_f64": _rel(chunks, want)}


def _model(cfg, seed):
    return build_model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(seed))


def part_model(cfg, seed):
    model = _model(cfg, seed)
    P = 2048
    toks = torch.randint(0, cfg.vocab_size, (1, P + 1),
                         generator=torch.Generator().manual_seed(seed + 1))
    outs = {}
    hooks = [blk.register_forward_hook(
        lambda mod, a, out, i=i: outs.setdefault(i, []).append(out[0]))
        for i, blk in enumerate(model.blocks)]
    lf, _, _ = model(toks, logits_slice=1)
    _, cache = steps.make_prefill_step(cfg, P + 2)(model, toks[:, :P])
    ld, _ = steps.make_decode_step(cfg)(model, cache, toks[:, P:])
    for h in hooks:
        h.remove()
    blocks = [{"block": i, "kind": model.plan[i][0],
               "max_abs_x": float(outs[i][0].abs().max()),
               "decode_vs_parallel": _rel(outs[i][2][:, -1],
                                          outs[i][0][:, -1])}
              for i in range(len(model.blocks))]
    keep = model.embed.detach().clone()
    model.embed.mul_(1 + 2.0 ** -23)
    lp, _, _ = model(toks, logits_slice=1)
    model.embed.copy_(keep)
    return {"decode_vs_parallel_logits": _rel(ld[:, -1], lf[:, -1]),
            "embed_ulp_perturbed_vs_parallel_logits": _rel(lp, lf),
            "max_abs_logit": float(lf.abs().max()), "blocks": blocks}


def part_reference(cfg, seed):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.models import lm as jlm
    from repro_torch.models.convert import lm_params_to_jax
    model = _model(cfg, seed)
    toks = torch.randint(0, cfg.vocab_size, (1, 2049),
                         generator=torch.Generator().manual_seed(seed + 1))
    tree = lm_params_to_jax(model)
    jcfg = jget_config(ARCH)
    want = jax.jit(lambda p, t: jlm.forward(jcfg, p, t, logits_slice=1)[0])(
        tree, jnp.asarray(toks.numpy(), jnp.int32))
    got, _, _ = model(toks, logits_slice=1)
    return {"port_vs_reference_logits": _rel(got, torch.from_numpy(
        np.array(want)))}


PARTS = {"layer": part_layer, "ragged": part_ragged, "model": part_model,
         "reference": part_reference}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default=",".join(PARTS))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = get_config(ARCH)
    for name in args.parts.split(","):
        t0 = time.perf_counter()
        with torch.no_grad():
            out = PARTS[name](cfg, args.seed)
        print(json.dumps({"part": name, "seed": args.seed,
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)


if __name__ == "__main__":
    main()
