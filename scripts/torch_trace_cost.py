#!/usr/bin/env python3
"""The cost of the port's spans (``omp_amg_tpu_torch/utils/trace.py``),
with the profiler off and on, in the benchmark's solve cells on one card.

    python3 scripts/torch_trace_cost.py [--cells pmis7_256.solve ...]
        [--solves 10] [--rounds 3] [--seed 7]

Off: nanoseconds per ``with span(name)`` while nothing profiles (timeit).
Per cell: the solver built as the benchmark builds it (``bench_port``'s
configuration, operator and solve arguments), warmed by one solve; then
``--rounds`` pairs of ``--solves`` certified solves of new right-hand
sides, each timed on the host clock up to a synchronize, in turns without
and with ``torch.profiler`` recording CPU and CUDA activity (one profiled
round first as its warm-up, untimed); and the program's spans per solve,
counted in the last profiled round. One JSON line per cell on stdout.
"""

import argparse
import json
import statistics
import sys
import time
import timeit
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
PREFIXES = ("amg.", "ir.", "graph.", "setup.", "build.")


def span_ns(n: int = 1_000_000) -> float:
    from omp_amg_tpu_torch.utils.trace import span

    t = min(timeit.repeat("with span('graph.block'): pass",
                          globals={"span": span}, number=n, repeat=5))
    return t / n * 1e9


def build(bench, name, seed, device):
    from harness import cells, spec
    from harness.problems import Problem

    cell = spec.cell(bench, name)
    config = spec.config(bench, cell["config"])
    dims = (int(config["n"]),) * len(config["stencil"]["taps"][0])
    run = SimpleNamespace(config=config, dims=dims, device=device,
                          tol=float(config["certify"]["tol"]), control=None,
                          seed=seed)
    problem = Problem(config, device,
                      on_device=config["solver"]["flavor"] == "device")
    solver = cells.make_solver(run, problem.dia())
    return run, solver, cells.solve_kwargs(run)


def measure(bench, name, args, device):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from harness import traffic

    run, solver, kw = build(bench, name, args.seed, device)
    n = 1
    for d in run.dims:
        n *= d
    index = [0]

    def solves():
        for _ in range(args.solves):
            b = traffic.rhs(n, args.seed, index[0], device, "cost")
            index[0] += 1
            solver.solve(b, **kw)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed():
        t = time.perf_counter()
        solves()
        return (time.perf_counter() - t) * 1e3 / args.solves

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    solver.solve(traffic.rhs(n, args.seed, 10 ** 6, device, "cost"), **kw)
    with profile(activities=activities):
        solves()                        # the profiler's warm-up
    off, on = [], []
    for _ in range(args.rounds):
        off.append(timed())
        with profile(activities=activities) as prof:
            on.append(timed())
    spans = sum(e.name.startswith(PREFIXES) for e in prof.events()
                if e.device_type.name == "CPU")
    return {"cell": name, "solves_per_round": args.solves,
            "off_ms": off, "on_ms": on,
            "off_median_ms": statistics.median(off),
            "on_median_ms": statistics.median(on),
            "on_over_off": statistics.median(on) / statistics.median(off),
            "spans_per_solve": spans / args.solves}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", nargs="+",
                   default=["struct7_256.solve", "pmis7_256.solve"])
    p.add_argument("--solves", type=int, default=10)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "bench_port"), str(ROOT)]
    import torch

    from harness import spec, timing

    print(json.dumps({"span_ns_profiler_off": span_ns()}), flush=True)
    if not torch.cuda.is_available():
        print("no CUDA card: the per-cell costs need one", file=sys.stderr)
        return 2
    print(f"card: {timing.card_info()}", file=sys.stderr, flush=True)
    bench = spec.load_benchmark(ROOT / "BENCHMARK.json")
    for name in args.cells:
        print(json.dumps(measure(bench, name, args, torch.device("cuda"))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
