"""cholupdate's share of its roofline: each launch (the rank-1 update of
every agent's full window with the one-slot shift) at its least time from
the shapes (costs.cholupdate_bound_ms) over the wavefront kernel's device
time in the traced slice, in %."""
from gpbench.costs import cholupdate_bound_ms
from gpbench.readings import roofline


def read(run):
    if "trace" not in run.layer:
        return None
    M, W, _ = run.layer["shape"]
    bound, _ = cholupdate_bound_ms(M, W, 1)
    return roofline(run, "cholupdate_wavefront", bound)
