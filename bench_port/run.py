#!/usr/bin/env python3
"""Benchmark of omp_amg_tpu_torch (the PyTorch/CUDA port) on one NVIDIA GPU.

Run one cell of ``BENCHMARK.json`` once, from the root of a checkout:

    python3 bench_port/run.py --workload pmis7_256.solve --seed 7 \\
        --seconds 30 --trace 0

It builds the cell's configuration, generates its traffic from ``--seed``,
sets up and warms the solver, measures for ``--seconds``, and prints one JSON
line last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` (each number compared, with its limit; also the last lines of
standard error). Without a CUDA card, with fewer cards than the cell asks
for, or with JAX or the JAX package loaded after the window, it exits
non-zero and prints no result.

``--control f32`` runs the program's own float32 solve (``certify=False``)
in place of the certified one: the control of the correctness check, which
has to come out not correct. The benchmark's own runs never pass it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "omp_amg_tpu")


def banned_modules() -> list:
    """Top-level names in ``sys.modules`` that the port's runs must not load,
    compared whole (``omp_amg_tpu_torch`` is not ``omp_amg_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("f32",), default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    # kernel caches at fixed paths inside the checkout (the program's own
    # build lands in omp_amg_tpu_torch/_build/)
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "cuda"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    if args.trace:
        os.environ["OMP_AMG_SETUP_TIMERS"] = "1"

    import torch

    from harness import cells, spec, timing

    bench = spec.load_benchmark(ROOT / "BENCHMARK.json")
    cell = spec.cell(bench, args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < int(cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} CUDA card(s); this "
              f"machine has {cards}", file=sys.stderr)
        return 2
    print(f"card: {timing.card_info()}", file=sys.stderr, flush=True)
    result = cells.run_cell(bench, cell, args.seed, args.seconds,
                            bool(args.trace), "cuda", T0, args.control)
    found = banned_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}={c['value']!r} limit={c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
