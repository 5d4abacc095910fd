"""pcg_iters.solve: inner PCG iterations per certified solve, summed over
its outer passes (``last_info["iters"]``), the mean over the window."""

from harness import stats


def read(run):
    return stats.mean(s["iters"] for s in run.solves)
