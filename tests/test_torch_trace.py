"""The port's spans (``omp_amg_tpu_torch/utils/trace.py``) on the CPU, 16³:
a certified solve under ``torch.profiler`` records its facade span and,
inside it, the certified loop's and the block loop's spans with the counts
the solve's own records give; with the profiler off a span is the shared
no-op and changes nothing; the setup trace keeps its labels, and each of
its phases is a ``setup.<label>`` span, the device numeric phase of the
Galerkin product (``rap="probe"``) one of its own."""

import collections
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import omp_amg_tpu_torch as amg
from omp_amg_tpu_torch.solvers.graph import graph_stats
from omp_amg_tpu_torch.utils import trace

N = 16
PREFIXES = ("amg.", "ir.", "graph.", "setup.", "build.")
LOOP = ("ir.residual", "graph.start", "graph.block", "graph.flag",
        "graph.finish", "ir.update", "ir.result")


def _solver(path, **kw):
    a = amg.poisson3d_7pt(N)
    if path == "structured":
        return amg.AMGSolver(a, amg.AMGParams(), grid=(N,) * 3,
                             device="cpu", **kw)
    return amg.AMGSolver(a, amg.AMGParams(coarsening="pmis"), device="cpu",
                         **kw)


def _rhs(seed=0):
    return np.random.default_rng(seed).standard_normal(N ** 3)


def _spans(fn):
    """(result of ``fn``, [(name, start, end)] of the program's spans)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sorted(((e.name, e.time_range.start, e.time_range.end)
                        for e in prof.events()
                        if e.name.startswith(PREFIXES)),
                       key=lambda x: (x[1], -x[2]))


def _blocks(solver):
    return sum(s["blocks"] for s in graph_stats(solver.hierarchy).values())


@pytest.mark.parametrize("residual", ["device", "host"])
@pytest.mark.parametrize("path", ["pmis", "structured"])
def test_certified_solve_records_its_spans_inside_the_facade(path, residual):
    solver = _solver(path)
    solver.solve(_rhs(1), residual=residual)      # caches the block loop
    before = _blocks(solver)
    x, spans = _spans(lambda: solver.solve(_rhs(), residual=residual))
    info = solver.last_info
    passes = info["outer_iters"]
    assert info["certified_f64"] and info["residual"] == residual
    assert passes >= 1 and info["rel_residual"] <= 1e-8
    counts = collections.Counter(name for name, _, _ in spans)
    blocks = _blocks(solver) - before
    assert counts == {
        "amg.solve": 1,
        "ir.residual": passes + 1,
        "graph.start": passes,
        "graph.block": blocks,
        # the eager loop reads the flag before each block and once more
        "graph.flag": blocks + passes,
        "graph.finish": passes,
        "ir.update": passes,
        "ir.result": 1,
    }
    (s0, e0), = [(s, e) for name, s, e in spans if name == "amg.solve"]
    assert all(s0 <= s and e <= e0 for name, s, e in spans if name in LOOP)
    # a block lies inside no other loop span
    inner = [(s, e) for name, s, e in spans if name == "graph.block"]
    outer = [(s, e) for name, s, e in spans
             if name in LOOP and name != "graph.block"]
    assert not any(a <= s and e <= b for s, e in inner for a, b in outer)


def test_profiler_off_span_is_the_shared_no_op_and_x_is_unchanged():
    assert not torch.autograd._profiler_enabled()
    assert trace.span("amg.solve") is trace.span("graph.block")
    with trace.span("ir.residual") as inside:
        assert inside is None
    solver = _solver("pmis")
    x_off = solver.solve(_rhs(), residual="device")
    x_on, spans = _spans(lambda: solver.solve(_rhs(), residual="device"))
    assert spans
    assert np.array_equal(x_off, x_on)


def test_facade_spans_parent_the_setup_refresh_and_precondition(monkeypatch):
    monkeypatch.delenv("OMP_AMG_SETUP_TIMERS", raising=False)
    solver, spans = _spans(lambda: _solver("pmis", refreshable=True))
    names = [name for name, _, _ in spans]
    assert names.count("amg.setup") == 1
    assert any(n.startswith("setup.") for n in names)
    a2 = amg.poisson3d_7pt(N)
    a2 = amg.Dia(data=a2.data * 2.0, offsets=a2.offsets, dims=a2.dims)
    _, spans = _spans(lambda: solver.refresh(a2))
    (s0, e0), = [(s, e) for n, s, e in spans if n == "amg.refresh"]
    phases = [(s, e) for n, s, e in spans if n.startswith("setup.")]
    assert phases and all(s0 <= s and e <= e0 for s, e in phases)
    r = torch.ones(N ** 3)
    z, spans = _spans(lambda: solver.precondition(r))
    assert [n for n, _, _ in spans] == ["amg.precondition"]
    assert torch.equal(z, solver.precondition(r))


def _stem(label):
    """A label without the form a level took, which is known only at the
    phase's end: "L0 operator form (ConstDia)" → "L0 operator form"."""
    return re.sub(r" \([A-Za-z]+\)$", "", label)


SETUPS = {
    "pmis": lambda a: amg.amg_setup(a, amg.AMGParams(coarsening="pmis"),
                                    device="cpu"),
    "pmis-device": lambda a: amg.amg_setup(
        a, amg.AMGParams(coarsening="pmis", interp="direct"), device="cpu",
        flavor="device"),
    "pmis-probe": lambda a: amg.amg_setup(
        a, amg.AMGParams(coarsening="pmis", rap="probe"), device="cpu"),
    "pmis-device-probe": lambda a: amg.amg_setup(
        a, amg.AMGParams(coarsening="pmis", interp="direct", rap="probe"),
        device="cpu", flavor="device"),
    "structured": lambda a: amg.amg_setup(a, amg.AMGParams(),
                                          grid=(N,) * 3, device="cpu"),
    "structured-device": lambda a: amg.amg_setup(
        a, amg.AMGParams(), grid=(N,) * 3, device="cpu", flavor="device"),
}


@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_setup_trace_keeps_its_labels_and_each_phase_is_a_span(
        setup, monkeypatch, capsys):
    monkeypatch.setenv("OMP_AMG_SETUP_TIMERS", "1")
    a = amg.poisson3d_7pt(N)
    SETUPS[setup](a)
    plain = amg.last_setup_trace()
    _, spans = _spans(lambda: SETUPS[setup](a))
    traced = amg.last_setup_trace()
    labels = [label for label, _ in traced]
    assert labels and labels == [label for label, _ in plain]
    assert all(s >= 0 for _, s in traced)
    assert [n for n, _, _ in spans] == ["setup." + _stem(label)
                                        for label in labels]
    err = capsys.readouterr().err
    assert all(f"[setup] {label}: " in err for label in labels)


@pytest.mark.parametrize("setup", ["pmis-probe", "pmis-device-probe"])
def test_probe_numeric_phase_is_its_own_span_and_mark(setup, monkeypatch):
    monkeypatch.setenv("OMP_AMG_SETUP_TIMERS", "1")
    a = amg.poisson3d_7pt(N)
    hier, spans = _spans(lambda: SETUPS[setup](a))
    labels = [label for label, _ in amg.last_setup_trace()]
    levels = len(hier.levels)
    probes = [label for label in labels if label.endswith(" RAP probe")]
    assert probes == [f"L{l} RAP probe" for l in range(levels)]
    for l in range(levels):
        # the host product and the symbolic phase, the numeric phase, then
        # the copy of its values to the host
        i = labels.index(f"L{l} RAP probe")
        assert labels[i - 1] == f"L{l} RAP"
        assert labels[i + 1] == f"L{l} RAP probe copy"
    names = [n for n, _, _ in spans]
    assert [n for n in names if n.endswith(" RAP probe")] == [
        "setup." + label for label in probes]
    assert hier.rap_engines == ("probe",) * levels


def test_refresh_phases_are_spans_under_the_trace(monkeypatch):
    monkeypatch.setenv("OMP_AMG_SETUP_TIMERS", "1")
    a = amg.poisson3d_7pt(N)
    cache = amg.SetupCache()
    amg.amg_setup(a, amg.AMGParams(coarsening="pmis"), device="cpu",
                  cache=cache)
    a2 = amg.Dia(data=a.data * 2.0, offsets=a.offsets, dims=a.dims)
    _, spans = _spans(lambda: amg.amg_refresh(a2, cache))
    labels = [label for label, _ in amg.last_setup_trace()]
    assert labels[-3:] == ["coarse planes", "coarse factor", "pack+upload"]
    assert [n for n, _, _ in spans] == ["setup." + label for label in labels]


def test_a_phase_left_by_an_exception_is_closed_and_not_marked(monkeypatch):
    monkeypatch.setenv("OMP_AMG_SETUP_TIMERS", "1")
    t = trace.SetupTrace()

    def run():
        with t.phase("ok") as ph:
            ph.label += " (Dia)"
        with pytest.raises(ValueError):
            with t.phase("fails"):
                raise ValueError("a pattern moved")
        with t.phase("after"):
            pass

    _, spans = _spans(run)
    assert [label for label, _ in amg.last_setup_trace()] == ["ok (Dia)",
                                                              "after"]
    assert [n for n, _, _ in spans] == ["setup.ok", "setup.fails",
                                        "setup.after"]
    assert all(s <= e for _, s, e in spans)
