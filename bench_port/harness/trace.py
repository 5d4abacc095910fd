"""The traced window: ``torch.profiler`` over a few whole solves or steps,
after a warm-up step of the same solves or steps.

From the profiler's events, kept in memory and never written out:

- ``window_s``: the length of the window (the harness's ``bench.window``
  span);
- ``busy_s``: the union of the device's activity intervals (kernels,
  copies, fills) inside it, so overlapping work counts once; the images of
  host spans on the device timeline are no activity;
- ``device_ops``: the ten device operations that took the most time, summed
  by name;
- ``idle_gaps``: the device's idle intervals inside the window, each named
  by what the host was doing at its midpoint (the innermost host span or
  operator covering it), summed by that name, the ten longest.

The harness's own spans (``bench.*``: the request, the set-up, the
right-hand side) are recorded with ``record_function`` around its calls
into the program, so a gap names the layer the host was in.
"""

from __future__ import annotations

import bisect

import torch

from . import stats

WINDOW = "bench.window"
TOP = 10
NAME_CHARS = 160
# the profiler's own host bookkeeping, not the program's
PROFILER_HOST = ("Activity Buffer Request", "ProfilerStep")


def span(name: str):
    """A host span of the harness, seen by the profiler (a no-op when
    nothing profiles)."""
    return torch.profiler.record_function(name)


def profile_window(fn, device) -> dict:
    """Run ``fn`` twice under the profiler and summarise the second run: the
    first is the profiler's warm-up step, which takes the tracer's own
    start-up (its buffers, its first flush) out of the window."""
    from torch.profiler import ProfilerActivity, profile, schedule

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        sync()
        prof.step()
        with span(WINDOW):
            fn()
            sync()
        prof.step()
    return summarise(prof.events())


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type != DeviceType.CPU


def _is_span(e) -> bool:
    """A span's image on the device timeline (a ``record_function`` range),
    which is no device work."""
    return bool(getattr(e, "is_user_annotation", False)) \
        or e.name.startswith("bench.")


def short_name(name: str) -> str:
    """A kernel's name without its parameter list and leading ``void``, at
    most ``NAME_CHARS`` characters."""
    name = name.removeprefix("void ")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name[:NAME_CHARS].rstrip()


def _host_at(host, starts, t, scan: int = 4096) -> str:
    """The innermost host span or operator running at ``t``: of those that
    cover it, the one that started last (spans on a thread nest)."""
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(host[max(0, i - scan):i]):
        if e >= t and name != WINDOW:
            return name
    return "host: no span"


def summarise(events) -> dict:
    window = [e for e in events if e.name == WINDOW]
    if not window:
        raise RuntimeError("the profiler recorded no window span")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    device, host = [], []
    for e in events:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s:
            continue
        if _is_device(e):
            if not _is_span(e):
                device.append((s, t, short_name(e.name)))
        elif not e.name.startswith(PROFILER_HOST):
            host.append((s, t, e.name))
    busy = stats.merge((s, t) for s, t, _ in device)
    by_op = {}
    for s, t, name in device:
        by_op[name] = by_op.get(name, 0.0) + (t - s) * 1e-6
    by_host = {}
    host.sort()
    starts = [s for s, _, _ in host]
    for g0, g1 in stats.gaps(busy, w0, w1):
        name = _host_at(host, starts, 0.5 * (g0 + g1))
        by_host[name] = by_host.get(name, 0.0) + (g1 - g0) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:TOP]]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(t - s for s, t in busy) * 1e-6,
        "device_ops": top(by_op),
        "idle_gaps": top(by_host),
    }
