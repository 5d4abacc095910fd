"""The program spans over the device timeline (``harness/spans.py``): the
attribution on planted intervals, and the readers that use it, silent on a
CPU run."""

import time
from types import SimpleNamespace

import pytest

from harness import cells, spans, spec, trace

READERS = ("ir_ms.solve", "loop_idle_ms.solve")


def _event(name, start, end, device=False, id=0, link=0, annotation=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU, id=id,
        linked_correlation_id=link, is_user_annotation=annotation)


def _planted():
    return [
        _event(trace.WINDOW, 0.0, 1000.0),
        _event("bench.solve", 0.0, 900.0, id=1),
        _event("aten::randn", 0.0, 5.0, id=100),         # before the solve
        _event("amg.solve", 10.0, 880.0, id=2),
        _event("ir.residual", 20.0, 200.0, id=3),
        _event("aten::mul", 30.0, 40.0, id=101),
        _event("cudaLaunchKernel", 32.0, 38.0, id=9001, link=101),
        _event("graph.block", 300.0, 320.0, id=4),
        _event("cudaGraphLaunch", 305.0, 315.0, id=7001),  # links nothing
        _event("graph.flag", 320.0, 500.0, id=5),
        # device work: through the linked host event, through the runtime
        # call that launched it, and outside any program span
        _event("randn_kernel", 2.0, 8.0, True, id=9000, link=100),
        _event("mul_kernel", 100.0, 150.0, True, id=9001, link=101),
        _event("graph_kernel_a", 330.0, 400.0, True, id=7001),
        _event("graph_kernel_b", 400.0, 480.0, True, id=7001, link=4),
        # a span's image on the device timeline: no work
        _event("graph.block", 330.0, 480.0, True, annotation=True),
    ]


def test_busy_goes_to_the_innermost_span_of_its_linked_host_event():
    out = spans.attribute(_planted(), 1)
    rows = out["spans"]
    assert rows["ir.residual"]["busy_ms"] == pytest.approx(0.050)
    # one kernel through its cudaGraphLaunch, one linked to the span
    assert rows["graph.block"]["busy_ms"] == pytest.approx(0.150)
    assert rows["amg.solve"]["busy_ms"] == 0.0
    assert out["totals"]["busy_unattributed_ms"] == pytest.approx(0.006)
    assert out["totals"]["busy_ms"] == pytest.approx(0.206)


def test_gap_goes_to_the_span_over_its_midpoint():
    out = spans.attribute(_planted(), 1)
    rows = out["spans"]
    # 8..100: mid 54, inside ir.residual
    assert rows["ir.residual"]["idle_ms"] == pytest.approx(0.092)
    # 150..330 (mid 240) and 480..1000 (mid 740): amg.solve alone
    assert rows["amg.solve"]["idle_ms"] == pytest.approx(0.180 + 0.520)
    assert rows["graph.block"]["idle_ms"] == 0.0
    assert rows["graph.flag"]["idle_ms"] == 0.0
    assert rows["graph.flag"]["host_ms"] == pytest.approx(0.180)
    assert rows["ir.residual"]["calls"] == 1


def test_time_outside_the_solve_goes_to_no_program_span():
    out = spans.attribute(_planted(), 1)
    assert "bench.solve" not in out["spans"]
    assert "aten::randn" not in out["spans"]
    # 0..2: before any device work, the harness's span alone
    assert out["totals"]["idle_outside_ms"] == pytest.approx(0.002)
    # everything else is put down to program spans: busy + idle closes
    tot = out["totals"]
    assert tot["spans_busy_idle_ms"] == pytest.approx(
        tot["window_ms"] - tot["busy_unattributed_ms"]
        - tot["idle_outside_ms"])


def test_per_request_and_readers_on_a_planted_table():
    table = spans.attribute(_planted(), 2)
    run = SimpleNamespace(on_card=True, solver=object(),
                          mix={"traced_solves": 2}, span_table=table)
    assert spans.per_request(run, ("ir.residual", "ir.update"),
                             ("busy_ms", "idle_ms")) == \
        pytest.approx((0.050 + 0.092) / 2)
    assert spec.reader("ir_ms.solve")(run) == pytest.approx(0.071)
    assert spec.reader("loop_idle_ms.solve")(run) == 0.0
    # a program without spans: nothing to read
    run.span_table = {"spans": {}, "totals": {}}
    for name in READERS:
        assert spec.reader(name)(run) is None


def test_readers_return_none_on_a_cpu_run(small_bench):
    res = cells.run_cell(small_bench,
                         spec.cell(small_bench, "pmis7_256.solve"),
                         2 ** 31 + 7, 0.5, True, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    assert "pcg_iters.solve" in res["metrics"]
    for name in READERS:
        assert name not in res["metrics"]
