"""The whole training step's share of the card's peak: the window's
DEC-apx-GP iterations at their least time (costs.admm_iter_work:
Cholesky, inverse from the factor, gradient contraction, at the published
float32 and HBM peaks) over the window's seconds, in %."""
from gpbench.costs import admm_iter_work, least_s
from gpbench.readings import percent


def read(run):
    if "iters" not in run.layer:
        return None
    M, N, D = run.layer["shape"]
    return percent(run.layer["iters"] * least_s(*admm_iter_work(M, N, D)),
                   run.layer["window_s"])
