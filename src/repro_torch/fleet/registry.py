"""The prediction methods and trainer names the port knows.

Counterpart of `repro.fleet.registry`. `METHODS` holds the methods this
slice of the port serves; `validate_config` accepts every name the
reference registers but rejects, with a "not yet ported" error that names
the ROADMAP item, the methods and switches whose subsystems the port does
not have yet. No trainer is ported: `GPFleet.fit(train=True)` raises.
"""
from __future__ import annotations

from typing import NamedTuple


class MethodSpec(NamedTuple):
    """One registered prediction method."""
    name: str
    paper: str


METHODS: dict[str, MethodSpec] = {s.name: s for s in (
    MethodSpec("poe", "Alg. 5, eq. 12-13"),
    MethodSpec("gpoe", "Alg. 6, eq. 12-13"),
    MethodSpec("bcm", "Alg. 7, eq. 14-15"),
    MethodSpec("rbcm", "Alg. 8, eq. 14-15"),
)}

# methods and trainers the reference registers, with the ROADMAP queue A
# item that ports them
_LATER_METHODS = {name: "ROADMAP queue A item 3 (CBNN, grBCM, NPAE)"
                  for name in ("grbcm", "npae", "npae_star", "nn_poe",
                               "nn_gpoe", "nn_bcm", "nn_rbcm", "nn_grbcm",
                               "nn_npae")}
_LATER_METHODS["npae_sparse"] = "ROADMAP queue A item 6 (sparse experts)"
TRAINER_NAMES = ("fact", "c", "apx", "gapx", "dec-c", "dec-apx", "dec-gapx",
                 "dec-apx-sharded", "fact-sparse", "dec-apx-sparse")
TRAINING_ITEM = "ROADMAP queue A item 2 (training)"

# FleetConfig switches whose subsystems are not ported, by ROADMAP item
_LATER_SWITCHES = (
    ("sharded", "ROADMAP queue A item 7 (multi-GPU)"),
    ("routed", "ROADMAP queue A item 7 (multi-GPU)"),
    ("online", "ROADMAP queue A item 5 (online experts)"),
    ("sparse_m", "ROADMAP queue A item 6 (sparse experts)"),
    ("cache_cross", "ROADMAP queue A item 3 (CBNN, grBCM, NPAE)"),
)


def method_names() -> tuple[str, ...]:
    return tuple(METHODS)


def get_method(name: str) -> MethodSpec:
    """The ported method `name` (hyphens accepted); a method the reference
    has but the port does not yet raises ValueError, an unknown one
    KeyError."""
    name = name.replace("-", "_")
    spec = METHODS.get(name)
    if spec is not None:
        return spec
    if name in _LATER_METHODS:
        raise ValueError(f"method {name!r} is not yet ported to repro_torch "
                         f"({_LATER_METHODS[name]}); ported methods: "
                         f"{sorted(METHODS)}")
    raise KeyError(f"unknown prediction method {name!r}; registered "
                   f"methods: {sorted(METHODS)}")


def validate_config(cfg) -> None:
    """Reject a FleetConfig that names an unknown trainer or method, or
    asks for a method or switch that is not yet ported."""
    if cfg.trainer not in TRAINER_NAMES:
        raise KeyError(f"unknown trainer {cfg.trainer!r}; registered "
                       f"trainers: {sorted(TRAINER_NAMES)}")
    get_method(cfg.method)
    for field, item in _LATER_SWITCHES:
        if getattr(cfg, field) not in (False, None):
            raise ValueError(f"FleetConfig({field}={getattr(cfg, field)!r}) "
                             f"is not yet ported to repro_torch ({item})")
