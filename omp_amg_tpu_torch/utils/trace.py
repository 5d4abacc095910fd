"""The port's tracer: named spans on ``torch.profiler``'s timeline, and the
setup trace.

``span(name)`` opens a ``torch.profiler.record_function(name)`` range
while the profiler is recording, so the program's host spans lie on the
profiler's own clock beside the device's records, and each device
interval or idle gap can be put down to what the program was doing. While
the profiler is off it returns one shared no-op context after a single
check: nothing is allocated, timed or stored. The profiler being on is the
only switch. Spans of one call nest inside its facade span on one thread.

The spans, by layer:

- facade (``solver.py``): ``amg.solve``, ``amg.refresh``,
  ``amg.precondition``, and ``amg.setup`` (the hierarchy build of
  ``AMGSolver``);
- certified loop (``solvers/ir.py``): ``ir.residual`` (one f64 residual,
  its norm read on the host and the scaled f32 defect), ``ir.update``
  (x += ‖r‖·x̂), ``ir.result`` (x to the host, or nothing);
- captured loop (``solvers/graph.py``): ``graph.capture`` (warm-up and
  both captures), ``graph.start`` (copy-in, the ``tol`` fill, the start),
  ``graph.block`` (one block's replay, or one eager block or step),
  ``graph.flag`` (the host read of ``active``), ``graph.finish`` (the one
  host copy and the clone of x);
- setup: ``setup.<label>``, each phase of :class:`SetupTrace` (a
  structured refresh: ``L<k> RAP``, ``L<k> lmax``, ``L<k> operator form``
  per level and ``coarse factor``, under ``amg.refresh``); with
  ``AMGParams(rap="probe")`` the PMIS setups' ``setup.L<l> RAP probe``
  holds level l's device numeric phase of the Galerkin product alone
  (marked when its device work ends), ``setup.L<l> RAP probe copy`` the
  selection of its values on the device and their copy to the host, and
  ``setup.L<l> RAP`` the host product and the probe's symbolic phase;
- kernels (``_build.py``): ``build.<library>``, one compiler run.

Counters: each kernel module's ``launches``, all read at once by
``ops.launch_counts()`` (``{kernel module: launches}``);
``amg/hierarchy.py``'s ``rap_products`` counts the Galerkin products of the
process by the engine that gave their values (``host``, ``probe``,
``comb``), and each hierarchy's ``rap_engines`` names that engine per
coarse operator; a PMIS setup's hierarchy holds ``level_rows`` and
``level_nnz``, each level's rows and stored nonzeros, the coarsest
included; ``AMGSolver.refresh_counts`` counts the facade's refreshes that
kept the recorded setup (``refreshed``) and those that ran a fresh setup
instead (``fell_back``). None of them costs anything in a solve.

:class:`SetupTrace` is the setups' per-phase trace. ``OMP_AMG_SETUP_TIMERS=1``
prints ``[setup] <label>: <s>`` to stderr per phase (the seconds since the
previous phase ended) and keeps the records for :func:`last_setup_trace`.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import time

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while the profiler records, else
    the shared no-op context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def traced(name: str):
    """Decorator: the whole call in ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class _Phase:
    """An open phase: its ``label`` may be completed inside the phase (the
    form a level took), and ``sync`` set to a tensor the phase's end waits
    for."""

    def __init__(self, label: str):
        self.label = label
        self.sync = None


_LAST_TRACE: list = []


class SetupTrace:
    """The phases of one setup or refresh: ``with trace.phase(label):``
    runs a phase in the span ``setup.<label>``. Its end is marked where
    the trace is on (``OMP_AMG_SETUP_TIMERS=1``): ``[setup] <label>: <s>``
    to stderr, the seconds since the previous phase ended, and the record
    kept. ``sync`` set on the yielded phase to a CUDA tensor: the marked
    phase first synchronises its device, so that it ends when its device
    work does. A label completed inside the phase names its span by
    the part given when the phase began. A phase left by an exception is
    not marked. The most recent enabled trace is kept for
    :func:`last_setup_trace`."""

    def __init__(self):
        self.enabled = os.environ.get("OMP_AMG_SETUP_TIMERS") == "1"
        if self.enabled:
            global _LAST_TRACE
            self.records = []
            _LAST_TRACE = self.records
            self.t = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, label: str):
        ph = _Phase(label)
        with span("setup." + label):
            yield ph
            if not self.enabled:
                return
            if isinstance(ph.sync, torch.Tensor) and ph.sync.is_cuda:
                torch.cuda.synchronize(ph.sync.device)
        now = time.perf_counter()
        self.records.append((ph.label, now - self.t))
        print(f"[setup] {ph.label}: {now - self.t:.3f}s", file=sys.stderr,
              flush=True)
        self.t = now


def last_setup_trace():
    """Per-phase (label, seconds) records of the most recent traced setup
    (``OMP_AMG_SETUP_TIMERS=1``)."""
    return list(_LAST_TRACE)
