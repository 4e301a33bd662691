"""Language-model scaffolding of the port (counterpart of repro.models):
the dense transformer family, served and trained through the
hand-written flash_attention kernel."""
from .config import ArchConfig
from . import attention, common, convert, lm
from .lm import LM

__all__ = ["ArchConfig", "LM", "attention", "common", "convert", "lm"]
