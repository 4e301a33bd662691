"""Optimizers of the port (counterpart of repro.optim), built in-repo."""
from .adam import Optimizer, adam, apply_updates, sgd

__all__ = ["Optimizer", "adam", "apply_updates", "sgd"]
