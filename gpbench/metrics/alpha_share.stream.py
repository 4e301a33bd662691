"""Device time under `online.alpha` (each observe round's alpha = C^-1 y
by two triangular solves against every agent's window factor) over all
device time of the traced slice, in %."""
from gpbench.spans import device_share


def read(run):
    return device_share(run, "online.alpha")
