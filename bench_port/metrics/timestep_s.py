"""timestep_s: the window's wall over the whole steps completed in it (hand
over the operator, set up or refresh, one certified solve), host clock."""

from harness import stats


def read(run):
    return stats.per_item(run.window_s, len(run.steps))
