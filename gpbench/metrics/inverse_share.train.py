"""Device time under `train.inverse` (the explicit inverse from the
factor: the triangular solve against I, L^-T L^-1 and alpha alpha^T)
over all device time of the traced slice, in %."""
from gpbench.spans import device_share


def read(run):
    return device_share(run, "train.inverse")
