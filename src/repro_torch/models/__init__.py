"""Language-model scaffolding of the port (counterpart of repro.models):
the dense and MoE transformer, the jamba hybrid (mamba + attention +
MoE), the xLSTM (mLSTM + sLSTM blocks), the VLM patch prefix and the
whisper encoder-decoder, served and trained through the hand-written
flash_attention kernel (xLSTM runs no attention); `act_sharding` holds
the activation sharding hints."""
from .config import ArchConfig
from . import (act_sharding, attention, common, convert, encdec, lm, mamba,
               moe, xlstm)
from .encdec import EncDec
from .lm import LM
from .mamba import Mamba, mamba_layer
from .moe import MoE, moe_ffn
from .xlstm import MLSTM, SLSTM, mlstm_layer, slstm_layer


def build_model(cfg, **kw):
    """The port's model of `cfg`: `EncDec` for an encoder-decoder, `LM`
    otherwise (keyword arguments as theirs)."""
    return (EncDec if cfg.encdec else LM)(cfg, **kw)


__all__ = ["ArchConfig", "EncDec", "LM", "MLSTM", "Mamba", "MoE", "SLSTM",
           "act_sharding", "attention", "build_model", "common", "convert",
           "encdec", "lm", "mamba", "mamba_layer", "mlstm_layer", "moe",
           "moe_ffn", "slstm_layer", "xlstm"]
