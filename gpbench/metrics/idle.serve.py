"""Share of the traced slice in which no activity ran on the device:
1 - (union of device-activity intervals) / slice length, in %."""
from gpbench.readings import idle


def read(run):
    return idle(run) if "trace" in run.layer else None
