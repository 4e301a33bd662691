"""Share of the requests' time spent waiting in the front door before
their slot runs: the queue and pack stages of the scheduler's request
spans, summed over the window, over all their stages, in %."""
from gpbench.readings import percent

WAITING = ("queue", "pack")


def read(run):
    stages = run.layer.get("stages_s")
    if not stages:
        return None
    return percent(sum(stages[s] for s in WAITING), sum(stages.values()))
