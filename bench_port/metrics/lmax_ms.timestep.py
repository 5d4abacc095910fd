"""lmax_ms.timestep: milliseconds of the λmax estimates in one step's
refresh: the sum of the ``L* lmax`` marks of the program's most recent
setup trace (``OMP_AMG_SETUP_TIMERS=1``, the traced run only), which after
the traced window is the newest traced step's refresh. None without a
live solver, on an untraced run, and where the program marks no such
phase."""


def read(run):
    if run.solver is None or not run.traced:
        return None
    from omp_amg_tpu_torch import last_setup_trace

    marks = [s for label, s in last_setup_trace()
             if label.startswith("L") and label.endswith(" lmax")]
    return 1e3 * sum(marks) if marks else None
