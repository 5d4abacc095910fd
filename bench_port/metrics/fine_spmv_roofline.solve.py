"""fine_spmv_roofline.solve: the level-0 operator's product as a share of
its roofline (%), timed alone after an L2-evicting read."""

from harness import readers


def read(run):
    return readers.spmv_roofline(run, 0)
