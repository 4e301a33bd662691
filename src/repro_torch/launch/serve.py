"""LM serving launcher: batched prefill + autoregressive decode
(counterpart of repro.launch.serve).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
      --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b \
      --layers 4 --dtype bfloat16 --batch 2 --prompt-len 2048 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
      --reduced --batch 4 --prompt-len 32 --gen 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \
      --batch 4 --prompt-len 2048 --gen 32

Every family: dense and MoE transformers, jamba, xLSTM, the VLM
(internvl2: `vis_tokens` patch embeddings before the prompt) and the
whisper encoder-decoder (`enc_seq` frame embeddings encoded at the
prefill, the encoder states carried to every decode step). Weights are
random, drawn from a torch.Generator seeded with `--seed` (in `--dtype`,
float32 by default, the reference's initial scales), and so are the
prompts, frames and patch embeddings (0.1 x standard normal, as the
reference's stubs); nothing is downloaded. `--layers N` cuts the
(decoder's) depth to N layers at the published widths. Every attention
product of a prefill, of the whisper encoder and of every
cross-attention runs through the hand-written flash_attention kernel on
the card (its plain version on the CPU); cached decode steps attend over
the cache in plain PyTorch, as the reference does. xLSTM runs no
attention, so it launches no kernel. It runs on the card
unless `--device cpu` is given, and prints what the reference prints,
plus tok/s and the kernel's launches.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..device import resolve_device
from ..kernels import flash_attention as F
from ..models import build_model
from ..models.lm import layer_plan
from .steps import make_decode_step, make_prefill_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the (decoder's) depth to this many layers")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="the weights' and activations' dtype")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, prompts, gen: int, temperature: float = 0.0,
             generator=None, attention=None, frames=None, embeds=None):
    """Prefill `prompts` (B, P), then `gen` decode steps, as the reference's
    serve loop: the first generated token comes from the prefill's logits,
    each decode step feeds the last token back. Greedy unless
    `temperature` > 0 (then sampled with `generator`). `attention`
    replaces ops.flash_attention in the prefill (and, for whisper, in the
    decode steps' cross-attention). `frames` (B, enc_seq, d) are an
    encoder-decoder's input, encoded at the prefill; `embeds` (B,
    vis_tokens, d) a VLM's patch prefix.

    Returns a dict: tokens (B, gen), gaps (B, gen) the top-2 logit gap
    behind each token, prefill_logits (B, 1, V), prefill_s and decode_s
    (host clock, synchronized), and the flash_attention kernel launches of
    the prefill and of the decode steps."""
    cfg = model.cfg
    B, P = prompts.shape
    dev = model.device
    prefill = make_prefill_step(cfg, max_len=P + gen + cfg.vis_tokens + 1)
    decode = make_decode_step(cfg)

    gaps = []                     # top-2 logit gap behind each pick

    def pick(logits):
        last = logits[:, -1].to(torch.float32)
        top2 = torch.topk(last, 2, dim=-1).values
        gaps.append(top2[:, 0] - top2[:, 1])
        if temperature > 0:
            probs = torch.softmax(last / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)
        return last.argmax(-1, keepdim=True)

    _sync(dev)
    n0 = F.launches
    t0 = time.perf_counter()
    if cfg.encdec:
        prefill_logits, cache, enc_out = prefill(model, frames, prompts,
                                                 attention)
    else:
        prefill_logits, cache = prefill(model, prompts, embeds, attention)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    n1 = F.launches

    out = []
    tok = pick(prefill_logits)
    t0 = time.perf_counter()
    for _ in range(gen):
        out.append(tok[:, 0])
        if cfg.encdec:
            logits, cache = decode(model, cache, enc_out, tok,
                                   attention=attention)
        else:
            logits, cache = decode(model, cache, tok)
        tok = pick(logits)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return {"tokens": torch.stack(out, 1),
            "gaps": torch.stack(gaps[:gen], 1),
            "prefill_logits": prefill_logits, "prefill_s": prefill_s,
            "decode_s": decode_s,
            "prefill_launches": n1 - n0, "decode_launches": F.launches - n1}


def stub_inputs(cfg, batch: int, generator, device, dtype=torch.float32):
    """(frames, embeds): the reference's stub frontends, 0.1 x standard
    normal drawn from `generator` on `device` in `dtype`: whisper's frame
    embeddings (B, enc_seq, d) and a VLM's patch embeddings (B,
    vis_tokens, d); None where the family has none."""
    def draw(n):
        return (0.1 * torch.randn((batch, n, cfg.d_model),
                                  generator=generator, device=device)) \
            .to(dtype)
    return (draw(cfg.enc_seq) if cfg.encdec else None,
            draw(cfg.vis_tokens) if cfg.vis_tokens else None)


def attention_layers(cfg) -> int:
    """Attention products a prefill runs through the kernel: the encoder's
    and the decoder's self- and cross-attention of an encoder-decoder,
    one per attention layer of a decoder-only model."""
    if cfg.encdec:
        return cfg.enc_layers + 2 * cfg.num_layers
    return sum(kind.startswith("attn") for kind, *_ in layer_plan(cfg))


def run(args):
    """Build the model and prompts of `args` (parse_args), serve them and
    print the reference's report. Returns generate()'s dict plus the
    model and the prompts."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = cfg.with_overrides(num_layers=args.layers)
    dtype = getattr(torch, args.dtype)
    gen = torch.Generator(dev).manual_seed(args.seed)
    model = build_model(cfg, device=dev, dtype=dtype, generator=gen)
    B, P, G = args.batch, args.prompt_len, args.gen
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device=dev)
    frames, embeds = stub_inputs(cfg, B, gen, dev, dtype)
    out = generate(model, prompts, G, args.temperature, gen, frames=frames,
                   embeds=embeds)
    t_prefill, t_dec = out["prefill_s"], out["decode_s"]
    tokens = out["tokens"].cpu()
    print(f"{cfg.name}: prefill {B}x{P} in {t_prefill:.2f}s; "
          f"decoded {G} tokens/seq in {t_dec:.2f}s "
          f"({B * G / max(t_dec, 1e-9):.1f} tok/s) on {dev}")
    print(f"flash_attention kernel launches: {out['prefill_launches']} in "
          f"the prefill ({attention_layers(cfg)} attention layers), "
          f"{out['decode_launches']} in {G} decode steps")
    print("sample generations (token ids):")
    for b in range(min(B, 2)):
        print(" ", tokens[b][:16].tolist())
    return {**out, "model": model, "prompts": prompts, "frames": frames,
            "embeds": embeds}


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
