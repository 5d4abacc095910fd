"""The check that decides ``correct``, on whole runs at 16³ on the CPU: a
sound run passes; the control (the program's float32 solve) and each fault
the cells can have (an answer altered where it is produced; a step whose
operator is not taken in) fail. The same control at the cells' own sizes
is run on the card (``PERF.md``)."""

import time

import pytest
import torch

from harness import cells, spec

SEED = 2 ** 31 + 99
CELLS = ("pmis7_256.solve", "struct7_256.solve", "struct7_256.timestep")


def run(bench, name, control=None, seconds=1.0):
    return cells.run_cell(bench, spec.cell(bench, name), SEED, seconds,
                          False, "cpu", time.perf_counter(), control)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small_bench, name):
    res = run(small_bench, name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert res["checks"]["max_rel_residual"]["value"] <= 1e-8


def test_a_config_added_as_a_file_runs_correct(small_bench, tmp_path):
    """A 27-point configuration is one new file and one entry: the stencil
    is data that the generator and the reference both read."""
    import itertools
    import json

    taps = [list(t) for t in itertools.product((-1, 0, 1), repeat=3)]
    cfg = dict(spec.config(small_bench, "pmis7_256"), name="pmis27_8", n=8,
               stencil={"name": "27pt", "taps": taps,
                        "coefficients": [26.0 if not any(t) else -1.0
                                         for t in taps]})
    path = tmp_path / "pmis27_8.json"
    path.write_text(json.dumps(cfg))
    small_bench["configs"].append({"name": "pmis27_8", "file": str(path)})
    small_bench["workloads"].append({"name": "pmis27_8.solve",
                                     "config": "pmis27_8",
                                     "traffic": "solve", "chips": 1})
    res = run(small_bench, "pmis27_8.solve")
    assert res["correct"] and res["attempted"] > 0, res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_float32_is_not_correct(small_bench, name):
    res = run(small_bench, name, control="f32")
    assert not res["correct"]
    # three times the limit or more: the control's reading sets the upper
    # end (PERF.md)
    assert res["checks"]["max_rel_residual"]["value"] >= 3e-8


@pytest.mark.parametrize("name", CELLS)
def test_fault_answer_altered_is_not_correct(small_bench, name, monkeypatch):
    from omp_amg_tpu_torch import AMGSolver

    solve = AMGSolver.solve

    def altered(self, b, **kw):
        x = solve(self, b, **kw)
        x = torch.as_tensor(x).clone()
        x[len(x) // 2] += 1e-3 * float(x.abs().max())
        return x
    monkeypatch.setattr(AMGSolver, "solve", altered)
    assert not run(small_bench, name)["correct"]


def test_fault_operator_not_taken_in_is_not_correct(small_bench, monkeypatch):
    """A step that keeps its state: every solver is built on the first
    operator it was handed."""
    from omp_amg_tpu_torch import AMGSolver

    init = AMGSolver.__init__
    first = []

    def stale(self, a, *args, **kw):
        first.append(a)
        init(self, first[0], *args, **kw)
    monkeypatch.setattr(AMGSolver, "__init__", stale)
    res = run(small_bench, "struct7_256.timestep", seconds=2.0)
    assert not res["correct"]


@pytest.mark.cuda
def test_cell_runs_correct_on_the_card(card):
    """One short run of the first cell through ``run.py`` on the card."""
    import json
    import subprocess
    import sys

    from conftest import BENCH_DIR, ROOT

    out = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload",
         "pmis7_256.solve", "--seed", str(SEED), "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
