"""probe_rap_ms.solve: milliseconds of the Galerkin products' device
numeric phase (``AMGParams(rap="probe")``) in the cell's one setup: the sum
of the ``L* RAP probe`` marks of the program's setup trace
(``OMP_AMG_SETUP_TIMERS=1``, the traced run only), each phase ended by a
device sync. The copy of the values to the host is a phase of its own
(``L* RAP probe copy``), not counted here. None on a CPU run, and where
the program marks no such phase."""


def read(run):
    if not run.on_card or not run.traced:
        return None
    from omp_amg_tpu_torch import last_setup_trace

    marks = [s for label, s in last_setup_trace()
             if label.startswith("L") and label.endswith(" RAP probe")]
    return 1e3 * sum(marks) if marks else None
