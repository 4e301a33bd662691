"""Idle time of the device while the stream's caller was inside a
streaming-window span (`online.observe`, `.evict`, `.append`, `.alpha`)
or swapping the served factors (`engine.swap`, under `online.observe`),
over the traced slice, in %."""
from gpbench.spans import idle_share


def read(run):
    return idle_share(run, lambda k: k.startswith("online.")
                      or k == "engine.swap")
