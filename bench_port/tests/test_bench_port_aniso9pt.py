"""The 2D anisotropic 9-point configuration (``aniso9pt_4096``) as the
benchmark runs it, at 64² on the CPU: its stencil is the port's
``aniso2d_9pt``; a sound run is correct and its control is not; the readers
of its two metrics, ``operator_complexity.solve`` and
``vcycle_launches.solve``, read the hierarchy's sizes and are silent where
there is nothing to read."""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest

from harness import cells, spec

SEED = 2 ** 31 + 4321
CONFIG = "aniso9pt_4096"
CELL = "aniso9pt_4096.solve"
N = 64      # 4096 rows: the hierarchy has several levels, the run seconds


@pytest.fixture
def bench64(tmp_path):
    """``BENCHMARK.json`` with this configuration cut to ``N``²."""
    bench = spec.load_benchmark()
    entry = [c for c in bench["configs"] if c["name"] == CONFIG][0]
    cfg = dict(spec.config(bench, CONFIG), n=N)
    path = tmp_path / f"{CONFIG}.json"
    path.write_text(json.dumps(cfg))
    entry["file"] = str(path)
    return bench


def run(bench, control=None, traced=False):
    return cells.run_cell(bench, spec.cell(bench, CELL), SEED, 1.0, traced,
                          "cpu", time.perf_counter(), control)


def test_the_coefficients_are_the_ports_aniso2d_9pt():
    import omp_amg_tpu_torch as amg

    cfg = spec.config(spec.load_benchmark(), CONFIG)
    st = cfg["stencil"]
    a = amg.aniso2d_9pt(8)
    planes = np.asarray(a.data, np.float64)
    interior = 4 * 8 + 4        # row (4, 4): every neighbour in the grid
    for tap, c in zip(st["taps"], st["coefficients"]):
        dy, dx = tap
        want = planes[a.offsets.index(dy * 8 + dx), interior]
        # the port forms each tap as ε·m·k + k·m with h = 1/9 in f64: a few
        # ulps from the exact decimal written to 17 digits
        assert c == pytest.approx(want, rel=1e-15, abs=0), tap
    # an operator of zero row sum inside the grid, up to the rounding of
    # nine 17-digit decimals near 1
    assert abs(sum(st["coefficients"])) <= 1e-15
    assert [c for t, c in zip(st["taps"], st["coefficients"])
            if t in ([0, -1], [0, 1])] == [0.33266666666666667] * 2
    assert cfg["n"] == 4096 and len(st["taps"]) == 9


def test_the_threshold_is_half_and_nothing_is_cut():
    bench = spec.load_benchmark()
    cfg = spec.config(bench, CONFIG)
    assert cfg["solver"]["params"]["theta"] == 0.5
    entry = [c for c in bench["configs"] if c["name"] == CONFIG][0]
    assert entry["reduced"] == []
    assert spec.cell(bench, CELL)["chips"] == 1


def test_sound_run_is_correct_and_the_reader_reads_the_hierarchy(bench64):
    import omp_amg_tpu_torch as amg

    res = run(bench64, traced=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["checks"]["max_rel_residual"]["value"] <= 1e-8
    assert "vcycle_launches.solve" not in res["metrics"]    # a CPU run
    # the setup is deterministic: the same operator and parameters again,
    # with the host operators kept, give the sizes the reader summed
    cfg = spec.config(bench64, CONFIG)
    _, host = amg.amg_setup(amg.aniso2d_9pt(N),
                            amg.AMGParams(**cfg["solver"]["params"]),
                            device="cpu", keep_host=True)
    nnz = [op.nnz for op in host.ops]
    # the same integers summed in the same order: equal to the last bit
    assert res["metrics"]["operator_complexity.solve"]["value"] == \
        sum(nnz) / nnz[0]


def test_control_float32_is_not_correct(bench64):
    res = run(bench64, control="f32")
    assert not res["correct"]
    # three times the limit or more, as for the other cells: the float32
    # solve stops at its own 1e-8 and its answer reads ~1e-7 in float64
    assert res["checks"]["max_rel_residual"]["value"] >= 3e-8


def test_readers_are_silent_without_sizes_or_counters():
    hier = SimpleNamespace(level_nnz=(), levels=())
    run = SimpleNamespace(on_card=False, solver=SimpleNamespace(
        hierarchy=hier))
    assert spec.reader("operator_complexity.solve")(run) is None
    assert spec.reader("vcycle_launches.solve")(run) is None
    # a hierarchy of a program that records no sizes
    run.solver.hierarchy = SimpleNamespace(levels=())
    assert spec.reader("operator_complexity.solve")(run) is None
    run.solver = None
    assert spec.reader("operator_complexity.solve")(run) is None
    hier = SimpleNamespace(level_nnz=(100, 40, 10))
    run.solver = SimpleNamespace(hierarchy=hier)
    assert spec.reader("operator_complexity.solve")(run) == 1.5
