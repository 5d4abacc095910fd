"""The 27-point Chebyshev configuration with the device Galerkin product
(``pmis27_128_cheby``) as the benchmark runs it, at 16³ on the CPU: a sound
run is correct and its control is not; the readers of its two setup
metrics, ``probe_rap_ms.solve`` and ``rap_host_levels.solve``, are silent on
a CPU run and read the program's marks and engines where a run has them."""

import dataclasses
import time
from types import SimpleNamespace

import pytest

from harness import cells, spec

SEED = 2 ** 31 + 1234
CELL = "pmis27_128_cheby.solve"
READERS = ("probe_rap_ms.solve", "rap_host_levels.solve")


def run(bench, control=None, traced=False):
    return cells.run_cell(bench, spec.cell(bench, CELL), SEED, 1.0, traced,
                          "cpu", time.perf_counter(), control)


def test_the_configuration_asks_for_the_probe_and_chebyshev():
    bench = spec.load_benchmark()
    cfg = spec.config(bench, "pmis27_128_cheby")
    params = cfg["solver"]["params"]
    assert params["rap"] == "probe" and params["smoother"] == "chebyshev"
    taps = cfg["stencil"]["taps"]
    assert len(taps) == 27 and sum(cfg["stencil"]["coefficients"]) == 0
    assert cfg["n"] == 128
    entry = [c for c in bench["configs"] if c["name"] == cfg["name"]][0]
    assert entry["reduced"] == []


def test_sound_run_is_correct_and_silent_readers_on_the_cpu(small_bench):
    res = run(small_bench, traced=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["checks"]["max_rel_residual"]["value"] <= 1e-8
    assert "pcg_iters.solve" in res["metrics"]
    for name in READERS:
        assert name not in res["metrics"]


def test_control_float32_is_not_correct(small_bench):
    res = run(small_bench, control="f32")
    assert not res["correct"]
    assert res["checks"]["max_rel_residual"]["value"] >= 3e-8


@pytest.fixture
def probe_setup(monkeypatch):
    """A traced 16³ setup of the configuration's parameters on the CPU."""
    import omp_amg_tpu_torch as amg

    monkeypatch.setenv("OMP_AMG_SETUP_TIMERS", "1")
    params = spec.config(spec.load_benchmark(),
                         "pmis27_128_cheby")["solver"]["params"]
    return amg.amg_setup(amg.poisson3d_27pt(16), amg.AMGParams(**params),
                         device="cpu")


def test_readers_read_the_marks_and_engines_of_a_stub_run(probe_setup):
    hier = probe_setup
    run = SimpleNamespace(on_card=True, traced=True,
                          solver=SimpleNamespace(hierarchy=hier))
    ms = spec.reader("probe_rap_ms.solve")(run)
    assert ms is not None and ms >= 0
    assert spec.reader("rap_host_levels.solve")(run) == 0
    run.solver.hierarchy = dataclasses.replace(
        hier, rap_engines=("probe",) + ("host",) * (len(hier.levels) - 1))
    assert spec.reader("rap_host_levels.solve")(run) == len(hier.levels) - 1
    # a hierarchy that names no engines (a program without them)
    run.solver.hierarchy = SimpleNamespace(params=hier.params)
    assert spec.reader("rap_host_levels.solve")(run) is None
    # an untraced run has no marks to read
    run.traced = False
    assert spec.reader("probe_rap_ms.solve")(run) is None


def test_probe_reader_is_silent_without_probe_marks(monkeypatch):
    import omp_amg_tpu_torch as amg

    monkeypatch.setenv("OMP_AMG_SETUP_TIMERS", "1")
    amg.amg_setup(amg.poisson3d_27pt(12), amg.AMGParams(coarsening="pmis"),
                  device="cpu")
    run = SimpleNamespace(on_card=True, traced=True, solver=None)
    assert spec.reader("probe_rap_ms.solve")(run) is None
    assert spec.reader("rap_host_levels.solve")(run) is None
