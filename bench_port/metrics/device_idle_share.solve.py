"""device_idle_share.solve: 1 − device busy / wall over a few whole solves
under the profiler (busy: the union of device activity intervals)."""

from harness import readers


def read(run):
    return readers.idle_share(run)
