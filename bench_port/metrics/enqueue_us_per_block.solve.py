"""enqueue_us_per_block.solve: host microseconds to launch one captured
block (``graph_stats`` ``enqueue_s`` over blocks) in the window."""


def read(run):
    g = run.graphs
    if not g or not g["blocks"] or not run.on_card:
        return None
    return 1e6 * g["enqueue_s"] / g["blocks"]
