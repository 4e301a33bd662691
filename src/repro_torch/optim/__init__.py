"""Optimizers of the port (counterpart of repro.optim), built in-repo."""
from .adam import Optimizer, adam, apply_updates, sgd
from .adafactor import adafactor
from .schedules import constant, cosine, warmup_cosine

__all__ = ["Optimizer", "adam", "sgd", "adafactor", "apply_updates",
           "constant", "cosine", "warmup_cosine"]
