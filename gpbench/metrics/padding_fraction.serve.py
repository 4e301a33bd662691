"""Pad rows over dispatched rows of the front door's slots in the window
(its TenantStats counters), in %."""
from gpbench.readings import percent


def read(run):
    if "padded_rows" not in run.layer:
        return None
    pad, rows = run.layer["padded_rows"], run.layer["rows"]
    return percent(pad, pad + rows)
