"""Device time under `train.factor` (the covariance from the cached
geometry and its Cholesky, every ADMM iteration) over all device time of
the traced slice, in %."""
from gpbench.spans import device_share


def read(run):
    return device_share(run, "train.factor")
