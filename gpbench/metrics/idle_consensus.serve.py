"""Idle time of the device while the front door's worker was inside a
`consensus.dac` span (launching a tile's DAC sweeps), over the traced
slice, in %."""
from gpbench.spans import idle_share


def read(run):
    return idle_share(run, lambda k: k == "consensus.dac")
