"""Idle time of the device while the front door's worker was inside an
engine span other than DAC (`engine.predict`, `engine.tile`,
`engine.moments`: query upload, local moments' launches, a tile's weights,
summands and posterior), over the traced slice, in %."""
from gpbench.spans import idle_share


def read(run):
    return idle_share(run, lambda k: k.startswith("engine."))
