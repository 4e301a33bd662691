"""Online/streaming GP subsystem: sliding-window experts with incremental
rank-1 Cholesky factor maintenance, and dynamic fleet membership.

Counterpart of `repro.core.online`. The lifecycle facade
(`repro_torch.fleet.GPFleet` with FleetConfig(online=True)) drives this
module through `observe` / `drift` / `join` / `leave`."""
from .experts import (OnlineExperts, evict_oldest, from_batch, init_online,
                      observe, observe_fleet, refit)
from .membership import join, leave

__all__ = [
    "OnlineExperts", "init_online", "from_batch", "refit",
    "observe", "observe_fleet", "evict_oldest", "join", "leave",
]
