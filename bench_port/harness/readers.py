"""What the metric readers (``metrics/<name>.py``) share. Each returns the
number, or None where the run has nothing to read (the metric is then left
out of the result line). A device number is never read from a CPU run."""

from __future__ import annotations

import torch

from . import roofline, stats, timing


def idle_share(run):
    """1 − (union of the device's busy intervals) / the traced window."""
    p = run.profile
    if p is None or not run.on_card or p["window_s"] <= 0:
        return None
    return 1.0 - p["busy_s"] / p["window_s"]


def step_mean(run, field: str):
    return stats.mean(s[field] for s in run.steps if s[field] is not None)


def spmv_roofline(run, level: int):
    """Level ``level``'s operator product through the program's format
    dispatch (``ops/spmv.py::spmv``, whatever kernel serves it), timed
    alone after an L2-evicting read, as a percentage of its roofline:
    bytes counted from the operator object (:mod:`.roofline`) over the
    card's published bandwidth."""
    if not run.on_card or run.solver is None:
        return None
    levels = run.solver.hierarchy.levels
    if level >= len(levels):
        return None
    peak = timing.card_peak(torch.cuda.get_device_name(run.device))
    if peak is None:
        return None
    from omp_amg_tpu_torch.ops.spmv import spmv

    op = levels[level].a
    n_cols = int(getattr(op, "n_cols", op.n_rows))
    gen = torch.Generator(device=run.device)
    gen.manual_seed(run.seed)
    x = torch.randn(n_cols, generator=gen, device=run.device,
                    dtype=torch.float32)
    flush = timing.flush_buffer(run.device)
    ms = timing.cuda_ms(lambda: spmv(op, x), flush=flush)
    del flush
    return roofline.roofline_pct(roofline.spmv_bytes(op), ms, peak[0])


def vcycle_ms(run, reps: int = 20):
    """Device milliseconds of one V-cycle as the solve applies it: the
    preconditioner M⁻¹r (``AMGSolver.precondition``, what the captured PCG
    blocks call) captured once in a CUDA graph on the cell's hierarchy, and
    replayed ``reps`` times, each replay after an L2-evicting read."""
    if not run.on_card or run.solver is None:
        return None
    gen = torch.Generator(device=run.device)
    gen.manual_seed(run.seed)
    r = torch.randn(run.solver.hierarchy.levels[0].a.n_rows, generator=gen,
                    device=run.device, dtype=torch.float32)
    graph = timing.capture(lambda: run.solver.precondition(r), run.device)
    flush = timing.flush_buffer(run.device)
    ms = timing.cuda_ms(graph.replay, reps=reps, flush=flush)
    del graph, flush
    return ms
