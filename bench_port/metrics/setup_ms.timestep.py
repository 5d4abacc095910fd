"""setup_ms.timestep: milliseconds to take in a step's operator (a fresh
``AMGSolver`` or ``refresh``), a harness span ended by a device sync, the
mean over the window's steps."""

from harness import readers


def read(run):
    return readers.step_mean(run, "setup_ms")
