"""galerkin_ms.timestep: milliseconds of the Galerkin products per step,
the sum of the ``L* RAP`` marks of the program's setup trace
(``OMP_AMG_SETUP_TIMERS=1``, the traced run only), the mean over steps."""

from harness import readers


def read(run):
    return readers.step_mean(run, "galerkin_ms")
