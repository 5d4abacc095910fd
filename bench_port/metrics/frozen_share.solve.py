"""frozen_share.solve: iterations a captured block ran after the exit
(frozen: launched, nothing changed) over all the iterations the window's
blocks held (blocks × K), from ``graph_stats``."""


def read(run):
    g = run.graphs
    if not g or not g["slots"]:
        return None
    return g["frozen"] / g["slots"]
