"""Idle time of the device while the front door's worker was in its own
spans (`frontdoor.slot`, `.pack`, `.sync`, `.copy`, `.deliver`) or held a
batch back with rows pending (`frontdoor.wait` with pending > 0), over the
traced slice, in %."""
from gpbench.spans import idle_share


def read(run):
    return idle_share(run, lambda k: k.startswith("frontdoor.")
                      and k != "frontdoor.wait:no_work")
