"""solve_p95_ms: the 95th percentile (nearest rank) of every solve of the
window, each timed by CUDA events on the stream around the call (the
device's clock: from the request's first enqueued work to its last)."""

from harness import stats


def read(run):
    if not run.on_card:
        return None
    return stats.percentile([s["ms"] for s in run.solves],
                            95)
