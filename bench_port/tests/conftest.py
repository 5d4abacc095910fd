"""Shared set-up of the benchmark's own tests (run from the checkout root:
``python -m pytest bench_port/tests -q``; the card tests with ``-m cuda``
on a machine with one)."""

import json
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

SMALL_N = 16    # the CPU runs' grid: seconds per run
# a cell the benchmark does not hold yet (PERF.md, Open questions: the
# structured setup's coarsest level under a large shift), kept runnable
PENDING = ({"name": "struct7_256.timestep", "config": "struct7_256",
            "traffic": "timestep", "chips": 1},)


@pytest.fixture
def small_bench(tmp_path):
    """``BENCHMARK.json`` with every configuration cut to ``SMALL_N``³ and
    the pending cells added, for whole runs on the CPU."""
    from harness import spec

    bench = spec.load_benchmark()
    for entry in bench["configs"]:
        cfg = spec.config(bench, entry["name"])
        cfg["n"] = SMALL_N
        path = tmp_path / f"{entry['name']}.json"
        path.write_text(json.dumps(cfg))
        entry["file"] = str(path)
    bench["workloads"] += [dict(c) for c in PENDING]
    return bench


@pytest.fixture
def card():
    """Skips unless a CUDA card is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
