"""Device time under the consensus layer's spans (`consensus.dac`: the
engine's DAC sweeps of a tile, the agents' payloads to their network
sums) over all device time of the traced slice, in %."""
from gpbench.spans import device_share


def read(run):
    return device_share(run, "consensus.dac")
