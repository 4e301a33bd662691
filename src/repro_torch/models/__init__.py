"""Language-model scaffolding of the port (counterpart of repro.models):
the dense and MoE transformer, the jamba hybrid (mamba + attention +
MoE), the VLM patch prefix and the whisper encoder-decoder, served and
trained through the hand-written flash_attention kernel. xLSTM is not
yet ported (ROADMAP A11c)."""
from .config import ArchConfig
from . import attention, common, convert, encdec, lm, mamba, moe
from .encdec import EncDec
from .lm import LM
from .mamba import Mamba, mamba_layer
from .moe import MoE, moe_ffn


def build_model(cfg, **kw):
    """The port's model of `cfg`: `EncDec` for an encoder-decoder, `LM`
    otherwise (keyword arguments as theirs)."""
    return (EncDec if cfg.encdec else LM)(cfg, **kw)


__all__ = ["ArchConfig", "EncDec", "LM", "Mamba", "MoE", "attention",
           "build_model", "common", "convert", "encdec", "lm", "mamba",
           "mamba_layer", "moe", "moe_ffn"]
