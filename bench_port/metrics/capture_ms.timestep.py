"""capture_ms.timestep: milliseconds to capture the loop's graphs for a
step's new hierarchy (``graph_stats`` ``capture_s``), the mean over steps."""

from harness import readers


def read(run):
    return readers.step_mean(run, "capture_ms")
