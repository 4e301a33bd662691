"""repro_torch.chaos: seeded, replayable fault injection for the fleet.

A copy of `repro.chaos` (numpy only): the same plans draw the same
schedules from the same seeds in both packages.

    plan = FaultPlan(seed=7, dropouts=(Dropout(agent=2, at=0),),
                     straggle_every=3, straggle_ms=50.0)
    mean, var, info = fleet.predict(Xs, fault_plan=plan,
                                    allow_degraded=True)
    assert info["degraded"]

Consensus faults (dropouts, edge loss, NaN payloads) run the degraded
consensus path with explicit flags; serving faults (stragglers, injected
failures) ride `wrap_predict_fn` on the scheduler dispatch path
(`launch.scheduler`). docs/robustness.md describes the fault model and
the degradation semantics.
"""
from .faults import Dropout, FaultInjected, FaultPlan
from .inject import membership_events, wrap_predict_fn

__all__ = [
    "FaultPlan", "Dropout", "FaultInjected",
    "wrap_predict_fn", "membership_events",
]
