#!/usr/bin/env python3
"""How far the LM's float32 gradients on the card are from float64.

    python3 tools/lm_grad_witness.py [--arch internlm2-1.8b] [--batch 1]
                                     [--seq 4096] [--seed 0]

internlm2-1.8b (or --arch whisper-small, the encoder-decoder, with its
1,500 frames drawn from the seed) at its published widths and depth with
the reference's train_4k settings (remat), float32 weights drawn from
--seed, one batch of MarkovLMData (seed 1). It computes the gradient of
the family's loss four ways (three for whisper: its non-causal and
cross-attention have no kernel_delta_from_out variant here) and prints,
for each kind of parameter (its name without the layer index), the
largest max |g - g64| / max |g64| over the layers (every attention
weight and norm, the embedding and the head, the MLP of internlm2's
layers 0, 12 and 23: the rest is not kept, to fit the card):

  kernel          the port as it runs: the flash_attention kernel forward
                  under FlashAttentionFunction, whose backward forms
                  delta = sum_j p_j dp_j over the recomputed p;
  kernel_delta_from_out
                  the same kernel forward with the reference's delta =
                  sum_d dout * out (`flash_jnp._flash_bwd`), for the
                  comparison;
  plain           the plain attention (flash_attention_plain) under
                  autograd, float32;
  float64         the witness g64: the model in float64 with the
                  attention, the RMS norm and the cross-entropy computed
                  in float64 (the port's computes those two in float32).

It also prints the kernel's and the plain gradient's distance from each
other, the quantity chip_smoke.py's lm_train phase gates. Needs a card
with about 45 GB free at the default batch of 1. The card's name and
power limit head the output.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

ARCHS = ("internlm2-1.8b", "whisper-small")


def _kept(name: str) -> bool:
    parts = name.split(".")
    return parts[0] != "blocks" or parts[2] != "mlp" or \
        parts[1] in ("0", "12", "23")


def _kind(name: str) -> str:
    parts = name.split(".")
    if parts[0] in ("blocks", "enc_blocks", "dec_blocks"):
        return ".".join(parts[:1] * (parts[0] != "blocks") + parts[2:])
    return name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default=ARCHS[0], choices=ARCHS)
    args = ap.parse_args(argv)
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import MarkovLMData
    from repro_torch.kernels import flash_attention as F
    from repro_torch.launch import train
    from repro_torch.launch.steps import cfg_for_shape
    from repro_torch.models import build_model, common, encdec, lm
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg = cfg_for_shape(get_config(args.arch), "train_4k")
    gen = torch.Generator(dev).manual_seed(args.seed)
    model = build_model(cfg, device=dev, generator=gen)
    batch = train.make_batch(MarkovLMData(cfg.vocab_size, seed=1),
                             args.batch, args.seq, dev, cfg, gen)
    family = encdec if cfg.encdec else lm

    class DeltaFromOut(torch.autograd.Function):
        """The kernel forward, the reference's delta = sum dout * out."""

        @staticmethod
        def forward(ctx, q, k, v):
            out, lse = F.flash_attention_lse(q, k, v)
            ctx.save_for_backward(q, k, v, out, lse)
            return out

        @staticmethod
        def backward(ctx, dout):
            q, k, v, out, lse = ctx.saved_tensors
            return _bwd_delta_from_out(F, q, k, v, out, lse, dout)

    def delta_from_out(q, k, v, causal=True, window=None, scale=None):
        return DeltaFromOut.apply(q.contiguous(), k.contiguous(),
                                  v.contiguous())

    def plain(q, k, v, causal=True, window=None, scale=None):
        return F.flash_attention_plain(q, k, v, causal, window, scale)

    def grads(attention):
        model.zero_grad(set_to_none=True)
        loss, _ = family.loss_fn(cfg, model, batch, attention=attention)
        loss.backward()
        out = {n: p.grad for n, p in model.named_parameters()
               if _kept(n)}
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), out

    ways = [("kernel", None), ("plain", plain)]
    if not cfg.encdec:
        ways.insert(1, ("kernel_delta_from_out", delta_from_out))
    runs = {name: grads(att) for name, att in ways}
    model.double()
    torch.cuda.empty_cache()

    def rmsnorm64(x, w, eps=1e-5):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w

    def cross_entropy64(logits, labels, mask=None):
        ll = torch.gather(logits, -1, labels[..., None])[..., 0]
        return (torch.logsumexp(logits, -1) - ll).mean()

    def attention64(q, k, v, causal=True, window=None, scale=None):
        B, H, Sq, D = q.shape
        KH, Sk = k.shape[1], k.shape[2]
        g = H // KH
        s = (q.reshape(B, KH, g * Sq, D) @ k.transpose(-1, -2)
             * D ** -0.5).view(B, KH, g, Sq, Sk)
        s = s.masked_fill(~F.mask(Sq, Sk, causal, window, q.device),
                          float("-inf"))
        return (torch.softmax(s, -1).view(B, KH, g * Sq, Sk) @ v).view(
            B, H, Sq, D)

    common.rmsnorm, family.cross_entropy = rmsnorm64, cross_entropy64
    loss64, g64 = grads(attention64)
    report = {"arch": args.arch, "batch": args.batch, "seq": args.seq,
              "loss_float64": loss64,
              "loss": {k: v[0] for k, v in runs.items()},
              "max_rel_err_vs_float64": {}, "kernel_vs_plain": {}}
    for name, (_, g) in runs.items():
        worst = {}
        for n, want in g64.items():
            err = float((g[n].double() - want).abs().max()
                        / want.abs().max())
            worst[_kind(n)] = max(worst.get(_kind(n), 0.0), err)
        report["max_rel_err_vs_float64"][name] = worst
    for n, want in runs["plain"][1].items():
        err = float((runs["kernel"][1][n] - want).abs().max()
                    / want.abs().max())
        kind = _kind(n)
        report["kernel_vs_plain"][kind] = max(
            report["kernel_vs_plain"].get(kind, 0.0), err)
    print(json.dumps(report), flush=True)
    return 0


def _bwd_delta_from_out(F, q, k, v, out, lse, dout, chunk=1024):
    """flash_attention_bwd's causal chunked backward with the reference's
    delta = sum_d dout * out (`flash_jnp._flash_bwd`), Sq == Sk."""
    import torch
    B, H, S, D = q.shape
    KH = k.shape[1]
    g = H // KH
    sc = D ** -0.5
    q5, do5 = q.reshape(B, KH, g, S, D), dout.reshape(B, KH, g, S, D)
    lse5 = lse.reshape(B, KH, g, S)
    delta5 = (do5 * out.reshape(B, KH, g, S, D)).sum(-1)
    ok = F.mask(S, S, True, None, q.device)
    dq5 = torch.zeros_like(q5)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for c0 in range(0, S, chunk):
        c1 = min(c0 + chunk, S)
        R, C = S - c0, c1 - c0
        qs = q5[:, :, :, c0:].reshape(B, KH, g * R, D)
        dos = do5[:, :, :, c0:].reshape(B, KH, g * R, D)
        kc, vc = k[:, :, c0:c1], v[:, :, c0:c1]
        s = (qs @ kc.transpose(-1, -2)).mul_(sc).view(B, KH, g, R, C)
        s.masked_fill_(~ok[c0:, c0:c1], float("-inf"))
        p = s.sub_(lse5[:, :, :, c0:, None]).exp_().view(B, KH, g * R, C)
        ds = (dos @ vc.transpose(-1, -2)).view(B, KH, g, R, C) \
            .sub_(delta5[:, :, :, c0:, None]).view(B, KH, g * R, C) \
            .mul_(p).mul_(sc)
        dq5[:, :, :, c0:] += (ds @ kc).view(B, KH, g, R, D)
        dk[:, :, c0:c1] = ds.transpose(-1, -2) @ qs
        dv[:, :, c0:c1] = p.transpose(-1, -2) @ dos
    return dq5.view(B, H, S, D), dk, dv


if __name__ == "__main__":
    sys.exit(main())
