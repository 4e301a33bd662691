"""The whole streaming loop's share of the card's peak: the window's
observe rounds (costs.observe_round_work: five passes over the factors'
lower triangles) and query batches (costs.serve_row_work) at their least
time, at the published float32 and HBM peaks, over the window's seconds,
in %."""
from gpbench.costs import least_s, observe_round_work, serve_row_work
from gpbench.readings import percent


def read(run):
    if "rounds" not in run.layer:
        return None
    M, W, D = run.layer["shape"]
    work = run.layer["rounds"] * least_s(*observe_round_work(M, W)) \
        + run.layer["batches"] * run.layer["query_rows"] * least_s(
            *serve_row_work(M, W, D, run.layer["chunk"]))
    return percent(work, run.layer["window_s"])
