"""The whole serving path's share of the card's peak: the rows answered
in the window at their least time (costs.serve_row_work: cross-kernel,
mean, variance solve, at the published float32 and HBM peaks) over the
window's seconds, in %."""
from gpbench.costs import least_s, serve_row_work
from gpbench.readings import percent


def read(run):
    if "answered_rows" not in run.layer:
        return None
    M, Ni, D = run.layer["shape"]
    per_row = least_s(*serve_row_work(M, Ni, D, run.layer["chunk"]))
    return percent(run.layer["answered_rows"] * per_row,
                   run.layer["window_s"])
