"""nll_grad's share of its roofline: each launch (every agent's gradient
sums of one iteration) at its least time from the shapes
(costs.nll_grad_bound_ms) over the device time of its two kernels
(nll_grad_partial, nll_grad_reduce) in the traced slice, in %."""
from gpbench.costs import nll_grad_bound_ms
from gpbench.readings import kernel, percent


def read(run):
    if "trace" not in run.layer:
        return None
    M, N, D = run.layer["shape"]
    bound, _ = nll_grad_bound_ms(M, N, D)
    seconds, _ = kernel(run, "nll_grad")
    _, n = kernel(run, "nll_grad_partial")
    return percent(n * bound * 1e-3, seconds) if n else None
