"""rbf_matvec's share of its roofline: each launch (one chunk-row tile of
every agent) at its least time from the shapes (costs.rbf_matvec_bound_ms)
over the kernel's device time in the traced slice, in %."""
from gpbench.costs import rbf_matvec_bound_ms
from gpbench.readings import roofline


def read(run):
    if "trace" not in run.layer:
        return None
    M, Ni, D = run.layer["shape"]
    bound, _ = rbf_matvec_bound_ms(run.layer["chunk"], M, Ni, D)
    return roofline(run, "rbf_matvec", bound)
