"""repro_torch — the PyTorch/CUDA port of `repro`, for an NVIDIA H100.

Module paths and public names mirror the JAX package `repro`, so every
port module has exactly one counterpart there; inside, the code is plain
PyTorch on tensors with an explicit `device`. Entry points run on `cuda`
unless the caller passes `device="cpu"` (`resolve_device`). The package
imports neither `jax` nor anything of `repro`.

Ported so far, behind `repro_torch.fleet`: the replicated serving path of
the DAC family (poe, gpoe, bcm, rbcm and their centralized references),
with the streamed posterior mean on a hand-written CUDA kernel
(`kernels/csrc/rbf_matvec.cu`); training (DEC-apx-GP and the other ported
trainers), with the NLL gradient on `kernels/csrc/nll_grad.cu`; and the
streaming fleet (`core/online`: sliding windows, observe/drift/join/
leave), with the rank-1 factor update on `kernels/csrc/cholupdate.cu`;
the closed-loop mission (`scenario`); and the agent-sharded fleet
(`launch.mesh`, `core.prediction.ShardedEngine`, the ring collectives).
ROADMAP.md lists what is still to come.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
