"""repro_torch.fleet — the public API for the GP fleet lifecycle.

    FleetConfig   declarative config, field for field the reference's
    GPFleet       the facade: fit (train, then cache the factors) / predict
                  (with chaos fault plans) / health / to_server
    FleetDegraded a degraded answer the caller did not opt in to
    registry      the ported TRAINERS and METHODS and the not-yet-ported
                  rejections
"""
from .config import FleetConfig
from .fleet import FleetDegraded, GPFleet
from .registry import (METHODS, TRAINERS, MethodSpec, TrainerSpec,
                       get_method, get_trainer, method_names, trainer_names,
                       validate_config)

__all__ = ["FleetConfig", "FleetDegraded", "GPFleet", "METHODS",
           "MethodSpec", "TRAINERS", "TrainerSpec", "get_method",
           "get_trainer", "method_names", "trainer_names",
           "validate_config"]
