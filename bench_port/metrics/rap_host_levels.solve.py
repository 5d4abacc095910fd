"""rap_host_levels.solve: Galerkin products of the live solver's hierarchy
whose values came from the host although its parameters ask for the
device numeric phase (``AMGParams(rap="probe")``), from the hierarchy's
``rap_engines``. None on a CPU run, where the parameters ask for no probe,
and where the hierarchy names no engines."""


def read(run):
    if not run.on_card or run.solver is None:
        return None
    hier = run.solver.hierarchy
    engines = getattr(hier, "rap_engines", ())
    if not engines or hier.params.rap != "probe":
        return None
    return sum(e == "host" for e in engines)
