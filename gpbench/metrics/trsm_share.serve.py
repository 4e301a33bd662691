"""Device time of the triangular-solve kernels, by name (cuBLAS trsm and
trsv: the local variances' solves against each agent's factor), over all
device time of the traced slice, in %."""
from gpbench.readings import device_total, kernel, percent


def read(run):
    if "trace" not in run.layer:
        return None
    solves = kernel(run, "trsm")[0] + kernel(run, "trsv")[0]
    return percent(solves, device_total(run))
