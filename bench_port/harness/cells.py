"""Running one cell: set-up, the measured window, the traced window, the
metric readers, and the check that decides ``correct``.

A mix names its driver (``"driver"`` in ``traffic/<mix>.json``):

- ``solve``: a closed loop with one caller. Request i is a certified solve
  ``AMGSolver.solve(b_i, tol)`` of a new right-hand side b_i
  (:func:`.traffic.rhs`), handed over on the card and returned there.
  Set-up builds the solver once and warms it with one solve of its own
  right-hand side, which captures the loop's graphs.
- ``timestep``: one caller that hands over a new operator A_k = A + s_k·I
  each step (:func:`.traffic.shift_exponent`), takes it in, and makes one
  certified solve with a new right-hand side. The operator is taken in
  as the configuration's ``time_stepping`` says: ``"refresh"``
  (``AMGSolver.refresh``, values only) or ``"setup"`` (a fresh
  ``AMGSolver``; the previous one and its graphs are freed after the new
  one's solve). Set-up builds the first solver, with the refresh path a
  cold refresh, and one solve.

Both run whole requests or steps until the clock passes ``--seconds`` and
divide by the time actually taken. Nothing is built or compiled inside
the window but what the traffic itself asks for (a step's new hierarchy
and the capture of its graphs).

After the window the peak of device memory is read; with ``--trace 1`` a
few more requests or steps run under the profiler (:mod:`.trace`) and the
per-layer readers run on the live solver. Then the program's state is
freed and the plain reference (``reference.py``) judges a sample of the
window's answers, drawn from the seed, by their true float64 residual.
"""

from __future__ import annotations

import gc
import math
import sys
import time
import warnings

import torch

from . import spec, stats, timing, trace, traffic
from .problems import Problem


class Run:
    """Everything one run measured, for the readers (``metrics/*.py``) and
    the check."""

    def __init__(self, cell, config, mix, seed, seconds, traced, device,
                 t0, control=None):
        self.cell, self.config, self.mix = cell, config, mix
        self.seed, self.seconds, self.traced = int(seed), seconds, traced
        self.device = torch.device(device)
        self.t0 = t0
        self.control = control
        self.dims = (int(config["n"]),) * len(config["stencil"]["taps"][0])
        self.n = math.prod(self.dims)
        self.tol = float(config["certify"]["tol"])
        self.solver = None
        self.setup_s = None
        self.window_s = None
        self.solves = []        # per request of the window: index, ms, iters
        self.steps = []         # per step: index, j, setup_ms, galerkin_ms,
                                # capture_ms
        self.graphs = None      # the captured loop's totals over the window
        self.profile = None     # the traced window (trace.profile_window)
        self.attempted = 0
        self.failed = 0
        self.fallbacks = 0      # refreshes that fell back to a fresh setup
        self.samples = traffic.Reservoir(mix["checked_answers"], seed)
        # the sampled answers, copied here as they come: storage made once,
        # so that keeping them allocates nothing inside the window
        self.answers = torch.empty((self.samples.size, self.n),
                                   dtype=torch.float64, device=self.device)
        self.memory_peak_bytes = 0
        self._events = []
        self.phases = [("imports", time.perf_counter())]

    def mark(self, phase: str) -> None:
        """End set-up phase ``phase`` (printed with ``setup_s``)."""
        self.sync()
        self.phases.append((phase, time.perf_counter()))

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self):
        if self.on_card:
            torch.cuda.synchronize(self.device)


# --- the program's entry points, as the configuration states them ----------

def make_solver(run: Run, a, refreshable: bool = False):
    from omp_amg_tpu_torch import AMGParams, AMGSolver

    s = run.config["solver"]
    kw = {"device": run.device, "flavor": s["flavor"]}
    if s["grid"]:
        kw["grid"] = run.dims
    if refreshable:
        kw["refreshable"] = True
    return AMGSolver(a, AMGParams(**s["params"]), **kw)


def solve_kwargs(run: Run) -> dict:
    c = run.config["certify"]
    kw = {"tol": run.tol, "maxiter": int(c["maxiter"]),
          "variant": c["variant"]}
    if run.control == "f32":
        # the control: the program's own float32 solve, uncertified
        return dict(kw, certify=False)
    return dict(kw, residual=c["residual"], device_result=True)


def request(run: Run, solver, kw: dict, index: int, shift: float = 0.0,
            stream: str = "rhs", keep: bool = True):
    """One certified solve of right-hand side ``index``: timed, recorded,
    offered to the check's sample (``keep``)."""
    b = traffic.rhs(run.n, run.seed, index, run.device, stream)
    run.attempted += keep
    if run.on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t = time.perf_counter()
    try:
        with trace.span("bench.solve"):
            x = solver.solve(b, **kw)
    except Exception as e:     # a failed request: counted, the run goes on
        print(f"request {index} failed: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        run.failed += keep
        return None
    wall_ms = (time.perf_counter() - t) * 1e3
    if run.on_card:
        end.record()
    info = solver.last_info
    sound = run.control is not None or (
        info.get("certified_f64") and info["rel_residual"] <= run.tol)
    if not keep:
        return x
    if not sound:
        run.failed += 1
    rec = {"index": index, "ms": wall_ms, "iters": int(info["iters"])}
    if run.on_card:
        run._events.append((rec, start, end))
    run.solves.append(rec)
    slot = run.samples.offer((index, shift, stream))
    if slot is not None:
        run.answers[slot].copy_(torch.as_tensor(x))
    return x


def _device_times(run: Run) -> None:
    """Per-request milliseconds from the CUDA events around each solve (the
    device's clock, µs apart), once the window has ended."""
    run.sync()
    for rec, start, end in run._events:
        rec["ms"] = start.elapsed_time(end)
    run._events = []
    ms = [r["ms"] for r in run.solves]
    if ms:
        tenth = max(1, len(ms) // 10)
        print(f"request ms: min {min(ms)} median "
              f"{stats.percentile(ms, 50)} max {max(ms)}; first tenth "
              f"{stats.mean(ms[:tenth])} last tenth {stats.mean(ms[-tenth:])}",
              file=sys.stderr, flush=True)


def graph_totals(solver) -> dict:
    """The captured loop's counts summed over the hierarchy's runners:
    blocks, iterations the blocks held (blocks × K), frozen ones, host
    enqueue seconds, capture seconds, captured runners."""
    from omp_amg_tpu_torch.solvers.graph import graph_stats

    out = {"blocks": 0, "slots": 0, "frozen": 0, "enqueue_s": 0.0,
           "capture_s": 0.0, "captured": 0}
    for key, st in graph_stats(solver.hierarchy).items():
        out["captured"] += bool(st["captured"])
        out["blocks"] += st["blocks"]
        out["slots"] += st["blocks"] * int(key[-1])
        out["frozen"] += st["frozen"]
        out["enqueue_s"] += st.get("enqueue_s", 0.0)
        out["capture_s"] += st.get("capture_s", 0.0)
    return out


def _clocks(run: Run, when: str) -> None:
    """The card's clocks, power and temperature beside the window (stderr)."""
    if run.on_card:
        print(f"card {when} window: {timing.card_state()}", file=sys.stderr,
              flush=True)


def _window(run: Run, body) -> None:
    """Run ``body(i)`` for i = 0, 1, ... until the clock passes the run's
    seconds; the window's wall is the time actually taken."""
    _clocks(run, "before")
    run.sync()
    t0 = time.perf_counter()
    i = 0
    while True:
        body(i)
        i += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.sync()
    run.window_s = time.perf_counter() - t0
    _clocks(run, "after")


def _setup_done(run: Run) -> None:
    run.mark("first_solve")
    run.setup_s = run.phases[-1][1] - run.t0
    t, parts = run.t0, []
    for phase, end in run.phases:
        parts.append(f"{phase} {end - t}")
        t = end
    print(f"setup_s={run.setup_s} ({', '.join(parts)})", file=sys.stderr,
          flush=True)


def _peak(run: Run) -> None:
    if run.on_card:
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(
            run.device))
    print(f"memory_peak_bytes={run.memory_peak_bytes}", file=sys.stderr,
          flush=True)


# --- the drivers -----------------------------------------------------------

def drive_solve(run: Run) -> None:
    flavor = run.config["solver"]["flavor"]
    problem = Problem(run.config, run.device, on_device=flavor == "device")
    run.mark("operator")
    with trace.span("bench.setup"):
        run.solver = make_solver(run, problem.dia())
    run.mark("amg_setup")
    kw = solve_kwargs(run)
    # the warm-up: one solve, which captures the loop's graphs
    request(run, run.solver, kw, 0, stream="warm", keep=False)
    _setup_done(run)
    before = graph_totals(run.solver)
    _window(run, lambda i: request(run, run.solver, kw, i))
    after = graph_totals(run.solver)
    run.graphs = {k: after[k] - before[k] for k in after}
    _device_times(run)
    _peak(run)
    if run.traced:
        first = len(run.solves)
        run.profile = trace.profile_window(
            lambda: [request(run, run.solver, kw, first + i, keep=False)
                     for i in range(int(run.mix["traced_solves"]))],
            run.device)


def _galerkin_ms():
    """The ``L* RAP`` marks of the program's most recent setup trace, in
    milliseconds (None without them)."""
    from omp_amg_tpu_torch import last_setup_trace

    marks = [s for label, s in last_setup_trace()
             if label.startswith("L") and label.endswith(" RAP")]
    return 1e3 * sum(marks) if marks else None


def drive_timestep(run: Run) -> None:
    from omp_amg_tpu_torch.solvers.graph import drop_graphs

    cfg, mix = run.config, run.mix
    mode = cfg["time_stepping"]
    if mode not in ("refresh", "setup"):
        raise ValueError(f"time_stepping {mode!r}: refresh or setup")
    problem = Problem(cfg, run.device,
                      on_device=cfg["solver"]["flavor"] == "device")
    run.mark("operator")
    kw = solve_kwargs(run)
    exponents = mix["shift_exponents"]
    warm_shift = traffic.shift(exponents[0])
    with trace.span("bench.setup"):
        if mode == "refresh":
            run.solver = make_solver(run, problem.dia(), refreshable=True)
            run.solver.refresh(problem.dia(warm_shift))     # the cold one
        else:
            run.solver = make_solver(run, problem.dia(warm_shift))
    run.mark("amg_setup")
    request(run, run.solver, kw, 0, warm_shift, stream="warm", keep=False)
    _setup_done(run)

    def step(k: int, keep: bool = True) -> None:
        j = traffic.shift_exponent(exponents, run.seed, k)
        s = traffic.shift(j)
        with trace.span("bench.operator"):
            a = problem.dia(s)
        t = time.perf_counter()
        with trace.span("bench.setup"):
            if mode == "refresh":
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    run.solver.refresh(a)
                run.fallbacks += sum("pattern guard" in str(w.message)
                                     for w in caught)
                new = run.solver
            else:
                new = make_solver(run, a)
            run.sync()
        setup_ms = (time.perf_counter() - t) * 1e3
        galerkin = _galerkin_ms() if run.traced else None
        request(run, new, kw, k, s, keep=keep)
        if new is not run.solver:
            old, run.solver = run.solver, new
            drop_graphs(old.hierarchy)
            del old
        if keep:
            g = graph_totals(run.solver)
            run.steps.append({"index": k, "j": j, "setup_ms": setup_ms,
                              "galerkin_ms": galerkin,
                              "capture_ms": (1e3 * g["capture_s"]
                                             if g["captured"] else None)})

    _window(run, step)
    _device_times(run)
    _peak(run)
    print(f"steps={len(run.steps)} refresh_fallbacks={run.fallbacks}",
          file=sys.stderr, flush=True)
    if run.traced:
        first = len(run.steps)
        run.profile = trace.profile_window(
            lambda: [step(first + i, keep=False)
                     for i in range(int(mix["traced_steps"]))],
            run.device)


DRIVERS = {"solve": drive_solve, "timestep": drive_timestep}


# --- after the window ------------------------------------------------------

def free(run: Run) -> None:
    """Drop the program's state, so the reference runs on a card without it
    (the peak was read before)."""
    from omp_amg_tpu_torch.solvers.graph import drop_graphs

    if run.solver is not None:
        drop_graphs(run.solver.hierarchy)
    run.solver = None
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()


def check(run: Run) -> dict:
    """The sampled answers judged by the reference: the largest true
    float64 relative residual against the configuration's tolerance, and
    the failed requests against none."""
    import reference

    worst = -math.inf
    for (index, shift, stream), x in zip(run.samples.items, run.answers):
        b = traffic.rhs(run.n, run.seed, index, run.device, stream)
        rel = reference.rel_residual(run.config, shift, b, x)
        worst = max(worst, rel if math.isfinite(rel) else math.inf)
    if not run.samples.items or not math.isfinite(worst):
        worst = sys.float_info.max      # nothing judged, or a NaN answer
    return {"max_rel_residual": {"value": worst, "limit": run.tol},
            "failed": {"value": run.failed, "limit": 0}}


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             traced: bool, device, t0: float, control=None) -> dict:
    """One run of ``cell``: the result's fields, in the order printed."""
    config = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    run = Run(cell, config, mix, seed, seconds, traced, device, t0, control)
    DRIVERS[mix["driver"]](run)
    metrics = {}
    for entry in spec.metrics(bench, cell["name"], traced):
        value = spec.reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    free(run)
    checks = check(run)
    correct = (run.attempted > 0 and checks["failed"]["value"] == 0
               and checks["max_rel_residual"]["value"] <= run.tol)
    dev = {"platform": "gpu" if run.on_card else run.device.type,
           "kind": (torch.cuda.get_device_name(run.device) if run.on_card
                    else run.device.type),
           "count": int(cell["chips"]),
           "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": bool(correct), "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if run.profile is not None:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        result["breakdown"] = {"device_ops": run.profile["device_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
    result["checks"] = checks
    return result
