"""Nothing a run loads is JAX or the JAX package (top-level names compared
whole), and the reference loads nothing of the program."""

import subprocess
import sys

from conftest import BENCH_DIR, ROOT

PROBE = """
import sys
sys.path[:0] = [{bench!r}, {root!r}]
{body}
tops = {{m.split(".")[0] for m in list(sys.modules)}}
print(sorted(tops & {{"jax", "jaxlib", "flax", "omp_amg_tpu",
                      "omp_amg_tpu_torch"}}))
"""


def _loaded(body: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(bench=str(BENCH_DIR),
                                            root=str(ROOT), body=body)],
        capture_output=True, text=True, timeout=300, check=True)
    return eval(out.stdout.strip().splitlines()[-1])


def test_harness_readers_and_program_load_no_jax():
    body = """
import run
from harness import cells, readers, spec, trace
import omp_amg_tpu_torch
from omp_amg_tpu_torch.ops.spmv import spmv
from omp_amg_tpu_torch.solvers.graph import graph_stats
bench = spec.load_benchmark()
for m in bench["end_to_end"] + bench["per_layer"]:
    spec.reader(m["name"])
"""
    assert _loaded(body) == ["omp_amg_tpu_torch"]


def test_the_reference_loads_nothing_of_the_program():
    assert _loaded("import reference") == []


def test_run_refuses_a_machine_without_the_cards_it_needs():
    """No card here: exit non-zero, no result line. (On a card this checks
    nothing: the test is for machines without one.)"""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload",
         "pmis7_256.solve", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
