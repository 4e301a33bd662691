"""repro_torch.fleet — the public API for the GP fleet lifecycle.

    FleetConfig   declarative config, field for field the reference's
    GPFleet       the facade: fit(train=False) / predict
    registry      the ported METHODS and the not-yet-ported rejections
"""
from .config import FleetConfig
from .fleet import GPFleet
from .registry import (METHODS, MethodSpec, get_method, method_names,
                       validate_config)

__all__ = ["FleetConfig", "GPFleet", "METHODS", "MethodSpec", "get_method",
           "method_names", "validate_config"]
