"""The captured-block runner: the port's counterpart of the reference's
jitted ``lax.while_loop`` PCG (``omp_amg_tpu/solvers/cg.py:64``, ``:121``;
sharded ``omp_amg_tpu/parallel/dist.py:377``, ``:410``).

A PCG variant is a :class:`Program` of three functions over a state (a
dict of device tensors, or of per-shard lists of them):

- ``start(b, tol, x0)``: r₀, the first preconditioned vector, the first
  scalars, an int32 iteration counter ``k``, a bool ``active`` flag, a
  history of ``maxiter + 1`` norms with entry 0 written, and the f32
  threshold formed from the f32 tolerance tensor ``tol`` and ‖b‖ (zero-b
  guarded), all on the device;
- ``step(state, masked)``: one iteration. With ``masked=True`` every update
  keeps the old value where the step's entry ``active`` is false (a
  ``torch.where(active, new, old)`` for the scalars and the vectors made
  anew, such as the cycle's; the in-place updates of x, r, p and s through
  ``ops/pcg_update.py`` then write nothing), ``k`` grows
  only while active, the history entry is written at a device index, and
  ``active`` is recomputed from the variant's own exit test and ``k <
  maxiter``; an iteration run after the exit (a *frozen* one) launches its
  kernels and changes nothing. With ``masked=False`` (the caller knows the
  state is active) the vector and scalar updates are plain;
- ``finish(state)``: one host copy of ``k``, the history and the scalars of
  the result, and the :class:`~.cg.CGResult`.

:func:`run` drives a program three ways, all through the same functions:

- ``graph=False``: the per-iteration loop, one unmasked step per host read
  of ``active``;
- ``graph=True`` on CPU tensors, or with ``capture=False`` (a process
  mesh, whose collectives run on the host and cannot be captured) on any
  device: the eager block loop, ``BLOCK`` masked steps per host read of
  ``active``, the arithmetic the graph records, as an :class:`EagerBlocks`
  runner cached on the owner, so that :func:`graph_stats` reports it
  (``captured: False`` and the reason);
- ``graph=True`` on CUDA tensors: :class:`Captured`, two CUDA graphs over
  static buffers (b, the f32 ``tol``, the state), the start and a block of
  ``BLOCK`` masked steps, captured once per (owner, key) and cached on the
  owner (the hierarchy). The host replays the start and then blocks, reads
  one flag per block, and copies ``k``, the history and the final norm
  once at the end. A capture failure raises; it never falls back to the
  eager loop.

The graphs of an owner take their memory from one private pool
(:class:`GraphPool`, made at its first capture), which :func:`drop_graphs`
hands on to the owner that replaces it: a refreshed hierarchy's graphs are
captured into the memory the dropped graphs held, with no allocation from
the device. Capture does not empty the allocator's cache first, as
``torch.cuda.graph`` does: on a time step that refreshes its hierarchy,
the cudaFree calls of that emptying took 15–510 ms of a capture, at random
(the 256³ structured refresh on the H100). :func:`prepare` captures
without running (a refresh recaptures the graphs the replaced owner held).

The kernel wrappers count their launches while Python runs, that is at
capture. :class:`Captured` therefore records each counter's increment over
the capture of the start and of one block, restores the counters (the
capture executed nothing), and adds the increments on every replay, so the
counters keep counting the launches the card executed, frozen iterations
included. The vector or scalar path of ``dia_spmv``, ``remote_halo`` and
``panel_spmm`` is chosen on the host from ``data_ptr()`` alignment and is
frozen into the graph at capture; ``path_changed`` says whether the
captured launches took another path than the eager warm-up's. A caller
that names the code path of a capture (``path``: the program and the forms
of its operators) skips the warm-up where the pool already holds a warmed
capture of that path, and compares the launches with that one's.

Under ``torch.profiler`` a run's phases are spans (:mod:`..utils.trace`):
``graph.capture``, ``graph.start``, ``graph.block`` (a replay: the
interval ``enqueue_s`` times; on the eager loops one block or step),
``graph.flag`` and ``graph.finish``.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, NamedTuple

import torch

from ..ops import kernel_modules
from ..utils.trace import span

# K, the PCG iterations per captured block. The certified 128³ solves run
# 8 + 3 (PMIS) and 10 + 4 (structured) inner iterations in 2 outer passes.
# A block that ends past the exit runs frozen iterations, each as long as a
# live one (a V-cycle: 0.6–0.9 ms at 128³ on the H100), while each block
# costs one host read of the flag and one graph launch (tens of µs). K = 4
# runs 3 + 1 blocks with 1 frozen iteration (PMIS) and 3 + 1 blocks with 2
# frozen (structured); PERF.md records the measured trade.
BLOCK = 4

COUNTERS = kernel_modules()


class Program(NamedTuple):
    start: Callable     # (b, tol, x0) -> state
    step: Callable      # (state, masked) -> state
    finish: Callable    # state -> CGResult (one host copy)


# --- state helpers (a value is a tensor or a per-shard list of tensors) -----

def vmap(fn, *vs):
    """``fn`` per shard of per-shard lists, or once on tensors."""
    if isinstance(vs[0], list):
        return [fn(*t) for t in zip(*vs)]
    return fn(*vs)


def selector(active: torch.Tensor, masked: bool):
    """``sel(new, old)``: ``torch.where(active, new, old)`` per tensor when
    masked, else ``new``."""
    if not masked:
        return lambda new, old: new
    return lambda new, old: vmap(lambda n, o: torch.where(active, n, o),
                                 new, old)


def new_history(maxiter: int, first: torch.Tensor):
    """(history of ``maxiter + 1`` NaNs with entry 0 ``first``, k = 0 as an
    int32 device scalar)."""
    hist = torch.full((maxiter + 1,), float("nan"), dtype=first.dtype,
                      device=first.device)
    hist[0] = first
    return hist, torch.zeros((), dtype=torch.int32, device=first.device)


def record(hist: torch.Tensor, at: torch.Tensor, value: torch.Tensor,
           write: torch.Tensor) -> None:
    """hist[at] = value where ``write`` (0-dim bool), through device
    indexing: no host int."""
    i = at.long().view(1)
    old = hist.index_select(0, i)
    hist.index_copy_(0, i, torch.where(write, value.view(1), old))


def advance(st: dict, maxiter: int, test: torch.Tensor) -> tuple:
    """(k, active) after a step: k + 1 where active; active while ``test``
    (the variant's exit test on the updated state) and k < maxiter."""
    act = st["active"]
    k = st["k"] + act.to(torch.int32)
    return k, act & test & (k < maxiter)


def guard(norm: torch.Tensor) -> torch.Tensor:
    """A norm of b with the zero-b guard (0 → 1)."""
    return torch.where(norm == 0, torch.ones_like(norm), norm)


def _leaves(v):
    return v if isinstance(v, list) else [v]


def _assign(dst: dict, src: dict) -> None:
    for name, v in src.items():
        for d, s in zip(_leaves(dst[name]), _leaves(v)):
            if d is not s:
                d.copy_(s)


def _clone(v):
    return [t.clone() for t in v] if isinstance(v, list) else v.clone()


def _shapes(v):
    """The shapes and dtypes of a state entry (a tensor or a shard list)."""
    return ([(t.shape, t.dtype) for t in v] if isinstance(v, list)
            else (v.shape, v.dtype))


def _empty(shapes, dev):
    """Uninitialised tensors of :func:`_shapes`'s ``shapes`` on ``dev``."""
    if isinstance(shapes, list):
        return [torch.empty(s, dtype=d, device=dev) for s, d in shapes]
    return torch.empty(shapes[0], dtype=shapes[1], device=dev)


def _device(v) -> torch.device:
    return _leaves(v)[0].device


# --- the launch counters -----------------------------------------------------

def counts() -> dict:
    """Every kernel wrapper's counters: {(module, attribute): value}."""
    return {(m, a): getattr(m, a) for m in COUNTERS
            for a in ("launches", "scalar_launches") if hasattr(m, a)}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _add(inc: dict) -> None:
    for (mod, attr), n in inc.items():
        setattr(mod, attr, getattr(mod, attr) + n)


def restore(snapshot: dict) -> None:
    for (mod, attr), n in snapshot.items():
        setattr(mod, attr, n)


# --- the runners -------------------------------------------------------------

def _block(program: Program, st: dict, k_block: int) -> dict:
    for _ in range(k_block):
        st = program.step(st, True)
    return st


def _eager(program: Program, b, tol: float, x0, k_block, stats=None):
    """The eager loops: ``k_block`` masked steps per read of ``active``, or
    (``k_block=None``) one unmasked step per read. ``stats``: the block
    loop's solves, blocks and frozen iterations are added there."""
    with span("graph.start"):
        st = program.start(b, torch.full((), tol, dtype=torch.float32,
                                         device=_device(b)), x0)
    blocks = 0
    while True:
        with span("graph.flag"):
            active = bool(st["active"])
        if not active:
            break
        with span("graph.block"):
            st = (program.step(st, False) if k_block is None
                  else _block(program, st, k_block))
        blocks += 1
    with span("graph.finish"):
        res = program.finish(st)
    if stats is not None:
        stats["solves"] += 1
        stats["blocks"] += blocks
        stats["frozen"] += blocks * k_block - res.iters
    return res


def capture_into(graph, pool, stream, fn) -> None:
    """Record ``fn`` into ``graph`` on ``stream``, its allocations from the
    private pool ``pool`` (a pool handle): ``torch.cuda.graph`` without the
    synchronisation and the emptying of the caches it begins with."""
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool)
        try:
            fn()
        finally:
            graph.capture_end()


@contextlib.contextmanager
def no_gc():
    """No garbage collection under capture: a collected object that owns a
    CUDA graph or pinned memory frees it, a call the capture forbids."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


class GraphPool:
    """A private memory pool, and the stream that captures into it, for the
    CUDA graphs of one owner and of the owners that replace it. The
    allocators (the device's and the pinned host memory's) forget a pool
    once no graph captured in it lives, and refuse a capture into it after
    that; a graph of one small kernel captured into it at the start
    (``anchor``, never replayed) keeps it. The allocator reuses a freed
    block only on the stream it was allocated on: one stream for every
    capture lets a later capture reuse the memory of graphs already
    dropped. ``warmed`` maps a code path to what its warmed capture
    found: the launch increments and the loop state's shapes. Dropping the
    object releases the pool."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.id = torch.cuda.graph_pool_handle()
        self.anchor = torch.cuda.CUDAGraph()
        self.warmed = {}
        with no_gc():
            capture_into(self.anchor, self.id, self.stream,
                         lambda: torch.zeros(1, device=device))


class Captured:
    """The start and a block of ``k_block`` masked steps of ``program``,
    captured as two CUDA graphs over static buffers shaped like ``b`` (and
    ``x0``). ``keep``: objects the graphs read that their owner does not
    hold (kept alive with the graphs). ``warmed``: the launch increments
    (start, block) and the state's shapes of a warmed capture of the same
    code path, in place of a warm-up (``self.warmed`` holds them after
    either)."""

    def __init__(self, program: Program, b, x0, k_block: int, keep=(),
                 pool=None, warmed=None):
        dev = _device(b)
        t0 = time.perf_counter()
        self.k_block = k_block
        self.finish = program.finish
        self.keep = keep
        self.b = _clone(b)
        self.x0 = None if x0 is None else _clone(x0)
        self.tol = torch.ones((), dtype=torch.float32, device=dev)
        self.pool = pool or GraphPool(dev)
        stream = self.pool.stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        if warmed is None:
            # warm-up on the capture stream: builds the kernel library, the
            # cuBLAS handle and every host-side cache before capture, and
            # runs the paths that the capture's launches are compared with
            c0 = counts()
            with torch.cuda.stream(stream):
                st = program.start(self.b, self.tol, self.x0)
                c1 = counts()
                st = _block(program, st, k_block)
                c2 = counts()
            self.state = {name: _clone(v) for name, v in st.items()}
            del st
            warmed = ((_delta(c1, c0), _delta(c2, c1)),
                      {name: _shapes(v) for name, v in self.state.items()})
        else:
            # the state outside the pool, as a warm-up leaves it: the start
            # graph writes every entry
            self.state = {name: _empty(v, dev)
                          for name, v in warmed[1].items()}
        self.warmed = warmed
        torch.cuda.synchronize(dev)
        reserved = torch.cuda.memory_reserved(dev)
        self.start_graph = torch.cuda.CUDAGraph()
        self.block_graph = torch.cuda.CUDAGraph()
        c0 = counts()
        with no_gc():
            capture_into(self.start_graph, self.pool.id, stream,
                         lambda: _assign(self.state, program.start(
                             self.b, self.tol, self.x0)))
            c1 = counts()
            capture_into(self.block_graph, self.pool.id, stream,
                         lambda: _assign(self.state, _block(
                             program, self.state, k_block)))
            c2 = counts()
        restore(c0)
        self.start_inc, self.block_inc = _delta(c1, c0), _delta(c2, c1)
        self.stats = {
            "captured": True,
            "capture_s": time.perf_counter() - t0,
            "pool_bytes": torch.cuda.memory_reserved(dev) - reserved,
            "solves": 0, "blocks": 0, "frozen": 0, "enqueue_s": 0.0,
            "path_changed": warmed[0] != (self.start_inc, self.block_inc),
        }

    def run(self, b, tol: float, x0=None):
        with span("graph.start"):
            for d, s in zip(_leaves(self.b), _leaves(b)):
                d.copy_(s, non_blocking=True)
            if x0 is not None:
                for d, s in zip(_leaves(self.x0), _leaves(x0)):
                    d.copy_(s, non_blocking=True)
            self.tol.fill_(tol)
            self.start_graph.replay()
        _add(self.start_inc)
        blocks = 0
        while True:
            with span("graph.block"):
                t0 = time.perf_counter()
                self.block_graph.replay()
                self.stats["enqueue_s"] += time.perf_counter() - t0
            _add(self.block_inc)
            blocks += 1
            with span("graph.flag"):
                active = bool(self.state["active"])
            if not active:
                break
        with span("graph.finish"):
            res = self.finish(self.state)
            # the state buffers are overwritten by the next solve
            res = res._replace(x=_clone(res.x))
        self.stats["solves"] += 1
        self.stats["blocks"] += blocks
        self.stats["frozen"] += blocks * self.k_block - res.iters
        return res


class EagerBlocks:
    """The eager block loop as a cached runner with the stats of
    :class:`Captured` (blocks and frozen iterations per solve), for a
    program that cannot be captured: ``reason`` says why."""

    def __init__(self, k_block: int, reason: str):
        self.k_block = k_block
        self.stats = {"captured": False, "reason": reason, "solves": 0,
                      "blocks": 0, "frozen": 0}

    def run(self, program: Program, b, tol: float, x0=None):
        return _eager(program, b, tol, x0, self.k_block, self.stats)


NOT_CAPTURED = {
    "cpu": "CPU tensors: CUDA graphs need the card",
    "mesh": ("a process mesh: its collectives run on the host (gloo) and "
             "cannot be captured in a CUDA graph"),
}


def run(program: Program, b, tol: float, x0=None, *, graph: bool = True,
        owner=None, key=None, keep=(), capture: bool = True, path=None):
    """Run ``program`` on ``b`` (see the module docstring). On CUDA with
    ``graph=True`` the captured graphs are cached on ``owner`` under ``key``
    (with the block size ``BLOCK``; ``path`` as in :func:`prepare`); on
    CPU tensors, or with ``capture=False`` on any device, the eager block
    loop is cached there instead."""
    if not graph:
        return _eager(program, b, tol, x0, None)
    cache = owner.__dict__.setdefault("_graphs", {})
    runner = cache.get((key, BLOCK))
    if not capture or _device(b).type != "cuda":
        if runner is None:
            runner = cache[(key, BLOCK)] = EagerBlocks(
                BLOCK, NOT_CAPTURED["mesh" if not capture else "cpu"])
        return runner.run(program, b, tol, x0)
    if runner is None:
        runner = prepare(program, b, x0, owner=owner, key=key, keep=keep,
                         path=path)
    return runner.run(b, tol, x0)


def prepare(program: Program, b, x0=None, *, owner, key, keep=(),
            path=None) -> Captured:
    """The :class:`Captured` runner of ``program`` cached on ``owner`` under
    ``key``, captured now if it is not there (CUDA tensors; nothing runs
    but the warm-up). ``path``: a function that names the capture's code
    path (a hashable value: the program and its operators' forms), or
    None; where the owner's pool holds a warmed capture of that path, the
    warm-up is skipped."""
    cache = owner.__dict__.setdefault("_graphs", {})
    runner = cache.get((key, BLOCK))
    if runner is None:
        pool = owner.__dict__.get("_graph_pool")
        path = path() if path is not None else None
        warmed = (pool.warmed.get(path)
                  if pool is not None and path is not None else None)
        with span("graph.capture"):
            runner = cache[(key, BLOCK)] = Captured(
                program, b, x0, BLOCK, keep, pool=pool, warmed=warmed)
        owner.__dict__["_graph_pool"] = runner.pool
        if path is not None and warmed is None:
            runner.pool.warmed[path] = runner.warmed
    return runner


def graph_stats(owner) -> dict:
    """{key: stats} of the graphs cached on ``owner``."""
    return {k: dict(r.stats) for k, r in
            getattr(owner, "_graphs", {}).items()}


def captured_keys(owner) -> list:
    """The keys of the captured runners cached on ``owner``."""
    return [key for (key, _), runner in getattr(owner, "_graphs", {}).items()
            if isinstance(runner, Captured)]


def drop_graphs(owner, successor=None) -> None:
    """Drop the graphs cached on ``owner`` (a hierarchy about to be
    replaced: the graphs read its tensors). With ``successor`` (the owner
    that replaces it) their memory pool passes to it, for the graphs it
    captures; without, the pool is released and its memory freed."""
    owner.__dict__.pop("_graphs", {}).clear()
    pool = owner.__dict__.pop("_graph_pool", None)
    if pool is None:
        return
    if successor is not None:
        successor.__dict__["_graph_pool"] = pool
    else:
        del pool
        torch.cuda.empty_cache()
