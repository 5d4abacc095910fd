"""vcycle_ms.solve: device milliseconds of one V-cycle as the solve applies
it: the preconditioner captured in a CUDA graph on the cell's hierarchy,
the mean of 20 replays, each after an L2-evicting read."""

from harness import readers


def read(run):
    return readers.vcycle_ms(run)
