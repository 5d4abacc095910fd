"""refresh_fallbacks.timestep: the steps whose refresh ran a fresh setup
instead of keeping the recorded one, over every refresh of the run (the
cold one, the window's, the traced ones), from the program's counter
``AMGSolver.refresh_counts["fell_back"]``. None without a live solver,
where the configuration steps by fresh setups, and on a program without
the counter."""


def read(run):
    if run.solver is None or run.config["time_stepping"] != "refresh":
        return None
    counts = getattr(run.solver, "refresh_counts", None)
    return None if counts is None else counts["fell_back"]
