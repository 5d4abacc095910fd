"""loop_idle_ms.solve: device idle milliseconds per certified solve under
the captured loop's spans (``graph.start``, ``graph.block``,
``graph.flag``, ``graph.finish``): the loop's host overhead as the device
sees it, block boundaries, start and finish included (:mod:`harness.spans`,
a few requests under the profiler)."""

from harness import spans


def read(run):
    return spans.per_request(
        run, ("graph.start", "graph.block", "graph.flag", "graph.finish"),
        ("idle_ms",))
