"""Training launcher: real steps on the card (counterpart of
repro.launch.train).

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --reduced --steps 50 --batch 8 --seq 128 --device cpu \\
      [--consensus dec_admm]
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --shape train_4k --batch 2 --steps 3 --lr 1e-4

--reduced runs the smoke-scale variant (CPU-friendly); without it the
configuration runs at its published widths. Every family: whisper's
batches carry frame embeddings (B, enc_seq, d) and a VLM's its
patch embeddings (B, vis_tokens, d), both 0.1 x standard normal drawn
from the run's generator as the reference's stubs, and a VLM's sequence
is at least vis_tokens + 16 tokens. --shape NAME applies the
reference's per-shape settings (`steps.cfg_for_shape`: train_4k turns on
remat) and, unless --seq is given, that shape's sequence length; the
batch stays --batch.
--consensus dec_admm runs the paper's decentralized ADMM training: one LM
per agent (each on its agent mesh member's device), ring messages only.
Weights are random, drawn from a torch.Generator seeded with --seed, in
float32 with the reference's initial scales; batches come from
MarkovLMData, the reference's numpy stream. Every attention layer runs
the hand-written flash_attention kernel forward on the card (its plain
version on the CPU) and the ported chunked backward. It runs on the card
unless --device cpu is given, and prints what the reference prints, plus
ms per step, tokens/s and the kernel's launches. --ckpt saves the
(agent-mean) parameters in the reference's layout, so
`repro.checkpoint.restore` loads them.
"""
from __future__ import annotations

import argparse
import copy
import time

import torch

from ..checkpoint import save_checkpoint
from ..configs import get_config
from ..core import federated
from ..data.lm_data import MarkovLMData
from ..device import resolve_device
from ..kernels import flash_attention as F
from ..models import build_model
from ..models.convert import lm_tree_to_jax
from .mesh import make_agent_mesh
from .steps import (SHAPES, cfg_for_shape, make_federated_train_step,
                    make_train_step, pick_optimizer)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=None,
                    help="tokens a sequence (default: the --shape's, else "
                         "128)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--consensus", default="allreduce",
                    choices=["allreduce", "dec_admm"])
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--rho", type=float, default=0.1)
    ap.add_argument("--kappa", type=float, default=None,
                    help="default: 1/lr (the ADMM proximal term acts as the"
                         " inverse step size)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES),
                    help="the reference's per-shape settings and sequence "
                         "length (train_4k: remat, 4,096 tokens)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random initial weights")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def make_batch(data, batch: int, seq: int, device, cfg=None,
               generator=None):
    """One (tokens, labels) batch of `data` as int64 tensors on `device`;
    with `cfg` an encoder-decoder's batch also carries frames (B,
    enc_seq, d) and a VLM's embeds (B, vis_tokens, d), 0.1 x standard
    normal float32 drawn from `generator` (on its device), as the
    reference's
    `make_batch` draws them."""
    toks, labels = data.batch(batch, seq)
    out = {"tokens": torch.from_numpy(toks).to(device, torch.int64),
           "labels": torch.from_numpy(labels).to(device, torch.int64)}
    if cfg is not None and (cfg.encdec or cfg.vis_tokens):
        n = cfg.enc_seq if cfg.encdec else cfg.vis_tokens
        at = generator.device if generator is not None else device
        out["frames" if cfg.encdec else "embeds"] = (0.1 * torch.randn(
            (batch, n, cfg.d_model), generator=generator, device=at)) \
            .to(device)
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def agent_devices(n_agents: int, device) -> tuple:
    """The device of each agent: agent a on member a * ndev // n_agents of
    the agent mesh (every visible card for `cuda`, the device alone
    otherwise), so every member holds n_agents / ndev agents."""
    device = torch.device(device)
    mesh = make_agent_mesh(n_agents,
                           devices=None if device.type == "cuda"
                           else (device,))
    ndev = mesh.size
    return tuple(mesh.devices[a * ndev // n_agents]
                 for a in range(n_agents))


def run(args):
    """Train as `args` (parse_args) says and print the reference's report.

    Returns a dict: cfg, losses (one float a step), step_s (host seconds
    a step, synchronized), flash_launches (kernel launches a step),
    tokens_per_step, and models (one LM per agent; one for allreduce);
    under dec_admm also duals and disagreement (the largest per-member
    consensus_disagreement after each logged step, else None)."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    seq = args.seq or 128
    if args.shape:
        cfg = cfg_for_shape(cfg, args.shape)
        seq = args.seq or SHAPES[args.shape]["seq"]
    if cfg.vis_tokens:
        seq = max(seq, cfg.vis_tokens + 16)
    gen = torch.Generator(dev).manual_seed(args.seed)
    model = build_model(cfg, device=dev, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {n_params / 1e6:.1f}M params, "
          f"consensus={args.consensus}")
    out = {"cfg": cfg, "losses": [], "step_s": [], "flash_launches": [],
           "tokens_per_step": 0}

    def timed(fn):
        _sync(dev)
        n0, t0 = F.launches, time.perf_counter()
        result = fn()
        _sync(dev)
        out["step_s"].append(time.perf_counter() - t0)
        out["flash_launches"].append(F.launches - n0)
        return result

    t_start = time.perf_counter()
    if args.consensus == "allreduce":
        optimizer, _ = pick_optimizer(cfg, args.lr)
        step_fn = make_train_step(cfg, optimizer)
        opt_state = optimizer.init(dict(model.named_parameters()))
        data = MarkovLMData(cfg.vocab_size, seed=0)
        out["tokens_per_step"] = args.batch * seq
        for s in range(args.steps):
            batch = make_batch(data, args.batch, seq, dev, cfg, gen)
            opt_state, loss, _ = timed(
                lambda: step_fn(model, opt_state, batch))
            out["losses"].append(float(loss))
            if s % args.log_every == 0 or s == args.steps - 1:
                print(f"step {s:4d} loss {out['losses'][-1]:.4f} "
                      f"({time.perf_counter() - t_start:.1f}s)", flush=True)
        del opt_state
        models = [model]
    else:
        M = args.agents
        kappa = args.kappa if args.kappa is not None else 1.0 / args.lr
        step_fn = make_federated_train_step(cfg, n_agents=M, rho=args.rho,
                                            kappa=kappa)
        devices = agent_devices(M, dev)
        # every agent starts from the same parameters, as the reference
        # broadcasts them over its agent axis
        models = [model.to(devices[0])] + [copy.deepcopy(model).to(d)
                                           for d in devices[1:]]
        del model
        duals = federated.dec_admm_init(
            [dict(m.named_parameters()) for m in models])
        datas = [MarkovLMData(cfg.vocab_size, seed=0, agent=a)
                 for a in range(M)]
        out["tokens_per_step"] = M * args.batch * seq
        out["disagreement"] = []
        for s in range(args.steps):
            batches = [make_batch(d, args.batch, seq, devices[a], cfg, gen)
                       for a, d in enumerate(datas)]
            duals, loss = timed(lambda: step_fn(models, duals, batches))
            out["losses"].append(float(loss))
            if s % args.log_every == 0 or s == args.steps - 1:
                with torch.no_grad():
                    dis = max(float(d) for d in
                              federated.consensus_disagreement(
                                  [dict(m.named_parameters())
                                   for m in models]))
                out["disagreement"].append(dis)
                print(f"step {s:4d} loss {out['losses'][-1]:.4f} "
                      f"disagreement {dis:.2e} "
                      f"({time.perf_counter() - t_start:.1f}s)", flush=True)
            else:
                out["disagreement"].append(None)
        out["duals"] = duals
    out["models"] = models
    if out["step_s"]:
        mean_s = sum(out["step_s"]) / len(out["step_s"])
        print(f"{cfg.name}: {1e3 * mean_s:.1f} ms per step, "
              f"{out['tokens_per_step'] / mean_s:.1f} tokens/s on {dev}; "
              f"flash_attention kernel launches per step "
              f"{out['flash_launches']}")

    if args.ckpt:
        with torch.no_grad():
            named = {n: torch.stack([dict(m.named_parameters())[n].to(dev)
                                     for m in models]).mean(0)
                     for n, _ in models[0].named_parameters()}
        path = save_checkpoint(args.ckpt, args.steps,
                               lm_tree_to_jax(models[0], named))
        print("saved", path)
    return out


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
