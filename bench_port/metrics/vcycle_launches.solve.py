"""vcycle_launches.solve: the hand-written kernels' launches in one eager
V-cycle, ``AMGSolver.precondition`` on the cell's hierarchy, as the
difference of ``omp_amg_tpu_torch.ops.launch_counts()`` around it after one
warm call. The torch operations of the V-cycle (vector adds and scales,
the coarse triangular solves) are not counted. None on a CPU run, where no
kernel launches, and where the program has no ``launch_counts``."""

import torch


def read(run):
    if not run.on_card or run.solver is None:
        return None
    from omp_amg_tpu_torch import ops

    counts = getattr(ops, "launch_counts", None)
    if counts is None:
        return None
    gen = torch.Generator(device=run.device)
    gen.manual_seed(run.seed)
    r = torch.randn(run.solver.hierarchy.levels[0].a.n_rows, generator=gen,
                    device=run.device, dtype=torch.float32)
    run.solver.precondition(r)          # the warm call
    run.sync()
    before = counts()
    run.solver.precondition(r)
    run.sync()
    after = counts()
    return sum(after[k] - before[k] for k in after)
