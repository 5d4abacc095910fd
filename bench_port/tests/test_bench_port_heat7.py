"""The backward-Euler configuration (``heat7_256``) as the benchmark runs it,
at 16³ on the CPU: each step refreshes the structured hierarchy
(``"time_stepping": "refresh"``), a sound run is correct with no refresh
falling back, its readers read numbers, and the control and a refresh that
keeps the old operator are not correct. The pending fresh-setup cell
(``struct7_256.timestep``) still runs."""

import time

import pytest

from harness import cells, spec

SEED = 2 ** 31 + 2407
CELL = "heat7_256.timestep"


def run(bench, name=CELL, control=None, traced=False, seconds=2.0):
    return cells.run_cell(bench, spec.cell(bench, name), SEED, seconds,
                          traced, "cpu", time.perf_counter(), control)


def test_the_configuration_is_struct7_256_stepped_by_refresh():
    bench = spec.load_benchmark()
    heat, struct = (spec.config(bench, c) for c in ("heat7_256",
                                                    "struct7_256"))
    for key in ("stencil", "n", "solver", "certify", "boundary"):
        assert heat[key] == struct[key], key
    assert heat["time_stepping"] == "refresh"
    assert struct["time_stepping"] == "setup"
    entry = [c for c in bench["configs"] if c["name"] == "heat7_256"][0]
    assert entry["reduced"] == []
    cell = spec.cell(bench, CELL)
    assert (cell["traffic"], cell["chips"]) == ("timestep", 1)


def test_sound_run_is_correct_and_its_readers_read(small_bench,
                                                   monkeypatch):
    monkeypatch.setenv("OMP_AMG_SETUP_TIMERS", "1")     # as run.py traces
    res = run(small_bench, traced=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["checks"]["max_rel_residual"]["value"] <= 1e-8
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["refresh_fallbacks.timestep"] == 0
    for name in ("setup_ms.timestep", "galerkin_ms.timestep",
                 "lmax_ms.timestep", "pcg_iters.solve"):
        assert m[name] > 0, name
    # device numbers and the captured loop's: the card only
    for name in ("device_idle_share.timestep", "capture_ms.timestep",
                 "solve_p95_ms", "vcycle_ms.solve",
                 "fine_spmv_roofline.solve", "coarse_spmv_roofline.solve"):
        assert name not in m, name


def test_an_untraced_run_reports_the_end_to_end_metrics(small_bench):
    res = run(small_bench)
    assert res["correct"], res["checks"]
    # solve_p95_ms: CUDA events, the card only
    assert set(res["metrics"]) == {"solve_ms", "setup_s"}
    assert res["metrics"]["solve_ms"]["value"] > 0


def test_control_float32_is_not_correct(small_bench):
    res = run(small_bench, control="f32")
    assert not res["correct"]
    assert res["checks"]["max_rel_residual"]["value"] >= 3e-8


def test_fault_refresh_keeps_the_old_operator(small_bench, monkeypatch):
    """A planted fault: ``refresh`` returns without taking the new operator
    in, so every step solves the first one."""
    from omp_amg_tpu_torch import AMGSolver

    monkeypatch.setattr(AMGSolver, "refresh", lambda self, a_new: self)
    assert not run(small_bench)["correct"]


@pytest.mark.parametrize("name", [CELL, "struct7_256.timestep"])
def test_timestep_cells_run_correct(small_bench, name):
    res = run(small_bench, name)
    assert res["correct"], res["checks"]
