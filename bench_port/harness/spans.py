"""The program's own spans over the device timeline.

After the traced window (:mod:`.trace`), a few more requests of the cell
(``traced_solves`` of the mix, new right-hand sides, through
:func:`.cells.request`) run under ``torch.profiler`` with CPU and CUDA
activity, after one warm-up step of the same requests, as
:func:`.trace.profile_window` runs them. The program records its spans
there (``omp_amg_tpu_torch/utils/trace.py``: names that start ``amg.``,
``ir.``, ``graph.``, ``setup.`` or ``build.``), and the device timeline of
the second step is put down to them:

- busy: a device interval goes to the innermost program span that covers
  the host event it is linked to (the operator or span open when it was
  launched: ``linked_correlation_id``) or, where it links to none (torch
  2.11's events carry no link), the CUDA runtime call that launched it
  (for a graph's kernels its ``cudaGraphLaunch``): the same correlation
  id;
- idle: each gap of the union of device intervals goes to the innermost
  program span over its midpoint.

Per span name and per request: calls, host ms (the spans' summed lengths),
device busy ms (the union of the intervals put down to it) and device idle
ms. The table is made once per run, kept on it and printed to stderr. A
program without spans gives a table without entries, where the readers
find nothing to read.
"""

from __future__ import annotations

import bisect
import sys

import torch

from . import stats, trace

PREFIXES = ("amg.", "ir.", "graph.", "setup.", "build.")


def _events(fn, device):
    """``fn`` twice under the profiler, the second time inside the window
    span: the profiler's events (the first run is its warm-up step)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize(device)
        prof.step()
        with trace.span(trace.WINDOW):
            fn()
            torch.cuda.synchronize(device)
        prof.step()
    return prof.events()


def _innermost(spans, starts, t):
    """The name of the innermost span of ``spans`` (sorted by start, a
    parent before a child that starts with it) covering ``t``, or None."""
    for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        s, e, name = spans[j]
        if e >= t:
            return name
    return None


def attribute(events, requests: int) -> dict:
    """The per-request table of the program spans in the window of
    ``events``: ``{"spans": {name: {calls, host_ms, busy_ms, idle_ms}},
    "totals": {...}}``, milliseconds per request."""
    window = [e for e in events if e.name == trace.WINDOW]
    if not window:
        raise RuntimeError("the profiler recorded no window span")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    spans, device = [], []
    linked, launched = {}, {}   # correlation id → host start (µs)
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        link = getattr(e, "linked_correlation_id", 0) or 0
        if trace._is_device(e):
            if not (trace._is_span(e) or e.name.startswith(PREFIXES)):
                s, t = max(s, w0), min(t, w1)
                if t > s:
                    device.append((s, t, link, e.id))
            continue
        if link or e.name.startswith("cu"):   # a CUDA API call: the
            launched[e.id] = s                  # launch itself
        else:                                   # an operator or a span
            linked[e.id] = s
        if e.name.startswith(PREFIXES) and s < w1 and t > w0:
            spans.append((s, t, e.name))
    spans.sort(key=lambda x: (x[0], -x[1]))
    starts = [s for s, _, _ in spans]
    rows = {}

    def row(name):
        return rows.setdefault(name, {"calls": 0, "host_ms": 0.0,
                                      "intervals": [], "idle_ms": 0.0})

    for s, t, name in spans:
        r = row(name)
        r["calls"] += w0 <= s
        r["host_ms"] += (min(t, w1) - max(s, w0)) * 1e-3
    unlinked = []
    for s, t, link, corr in device:
        at = linked.get(link) if link else None
        if at is None:
            at = launched.get(corr)
        name = None if at is None else _innermost(spans, starts, at)
        if name is None:
            unlinked.append((s, t))
        else:
            row(name)["intervals"].append((s, t))
    busy = stats.merge((s, t) for s, t, _, _ in device)
    idle_out = 0.0
    for g0, g1 in stats.gaps(busy, w0, w1):
        name = _innermost(spans, starts, 0.5 * (g0 + g1))
        if name is None:
            idle_out += (g1 - g0) * 1e-3
        else:
            row(name)["idle_ms"] += (g1 - g0) * 1e-3
    length = lambda iv: sum(t - s for s, t in stats.merge(iv)) * 1e-3
    per = 1.0 / requests
    table = {}
    for name, r in rows.items():
        table[name] = {"calls": r["calls"] * per,
                       "host_ms": r["host_ms"] * per,
                       "busy_ms": length(r["intervals"]) * per,
                       "idle_ms": r["idle_ms"] * per}
    busy_ms, unattributed = length(busy), length(unlinked)
    return {"spans": table, "totals": {
        "requests": requests,
        "window_ms": (w1 - w0) * 1e-3 * per,
        "busy_ms": busy_ms * per,
        "busy_unattributed_ms": unattributed * per,
        "busy_attributed_share": (1.0 - unattributed / busy_ms
                                  if busy_ms else None),
        "idle_outside_ms": idle_out * per,
        "spans_busy_idle_ms": sum(r["busy_ms"] + r["idle_ms"]
                                  for r in table.values()),
    }}


def _measure(run) -> dict:
    from . import cells

    kw = cells.solve_kwargs(run)
    n = int(run.mix["traced_solves"])
    # past the indices of the window and of the traced window
    first = len(run.solves) + n
    marks = []

    def requests():
        marks.clear()
        for i in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            cells.request(run, run.solver, kw, first + i, keep=False)
            end.record()
            marks.append((start, end))

    out = attribute(_events(requests, run.device), n)
    torch.cuda.synchronize(run.device)
    out["totals"]["event_ms"] = stats.mean(
        s.elapsed_time(e) for s, e in marks)
    _print(out)
    return out


def _print(out: dict) -> None:
    tot = out["totals"]
    print(f"program spans per request ({tot['requests']} requests under "
          f"torch.profiler; ms): name calls host busy idle", file=sys.stderr)
    for name, r in sorted(out["spans"].items(),
                          key=lambda kv: -(kv[1]["busy_ms"]
                                           + kv[1]["idle_ms"])):
        print(f"  {name} {r['calls']} {r['host_ms']} {r['busy_ms']} "
              f"{r['idle_ms']}", file=sys.stderr)
    print("  totals " + " ".join(f"{k}={v}" for k, v in tot.items()),
          file=sys.stderr, flush=True)


def table(run):
    """The span table of ``run`` (made at the first call, kept on the run),
    or None where there is nothing to profile: off the card, or a mix
    without traced solves."""
    if (not run.on_card or run.solver is None
            or "traced_solves" not in run.mix):
        return None
    if not hasattr(run, "span_table"):
        run.span_table = _measure(run)
    return run.span_table


def per_request(run, names, fields):
    """Σ of ``fields`` over the spans ``names``, ms per request; None where
    none of them was recorded."""
    t = table(run)
    rows = [t["spans"][n] for n in names if t and n in t["spans"]]
    if not rows:
        return None
    return sum(r[f] for r in rows for f in fields)
