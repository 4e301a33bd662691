"""Architecture registry: `get_config(arch_id)` resolves every assigned
architecture (plus smoke variants via ArchConfig.reduced()).

The configurations are data, copied from the reference's `repro.configs`;
the port's models run all of them.
The paper's GP experiment configuration is `configs.paper_gp.CONFIG`
(GPExperimentConfig), a copy of the reference's."""
from __future__ import annotations

import importlib

from ..models.config import ArchConfig

ARCH_IDS = [
    "dbrx-132b",
    "whisper-small",
    "jamba-v0.1-52b",
    "internlm2-1.8b",
    "xlstm-350m",
    "granite-3-8b",
    "phi3-medium-14b",
    "llama4-maverick-400b-a17b",
    "internvl2-76b",
    "chatglm3-6b",
]

_MODULES = {
    "dbrx-132b": "dbrx_132b",
    "whisper-small": "whisper_small",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "internlm2-1.8b": "internlm2_1_8b",
    "xlstm-350m": "xlstm_350m",
    "granite-3-8b": "granite_3_8b",
    "phi3-medium-14b": "phi3_medium_14b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "internvl2-76b": "internvl2_76b",
    "chatglm3-6b": "chatglm3_6b",
}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.CONFIG


__all__ = ["ARCH_IDS", "ArchConfig", "get_config"]
