"""solve_ms: the window's wall over the certified solves completed in it,
host clock: the cost per right-hand side."""

from harness import stats


def read(run):
    wall = stats.per_item(run.window_s, len(run.solves))
    return None if wall is None else 1e3 * wall
