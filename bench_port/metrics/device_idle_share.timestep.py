"""device_idle_share.timestep: 1 − device busy / wall over a few whole
steps under the profiler (busy: the union of device activity intervals)."""

from harness import readers


def read(run):
    return readers.idle_share(run)
