"""ir_ms.solve: device milliseconds per certified solve under the certified
loop's own spans (``ir.residual``, ``ir.update``, ``ir.result``), busy plus
idle: what the f64 wrapper around the captured PCG costs the solve's
device timeline (:mod:`harness.spans`, a few requests under the
profiler)."""

from harness import spans


def read(run):
    return spans.per_request(run, ("ir.residual", "ir.update", "ir.result"),
                             ("busy_ms", "idle_ms"))
