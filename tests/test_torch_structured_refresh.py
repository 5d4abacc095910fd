"""The structured refresh (``AMGSolver(..., grid=, refreshable=True)``,
``amg/refresh.py::structured_refresh``) and the structured setup's coarsest
level, on the CPU at ≤ 32³.

- A refresh of A + 2^-j·I is bitwise a fresh structured setup of it run
  with the cached axes (planes, dinv, λmax, forms, factor), both flavors;
  on the isotropic 7-point operator that is the plain fresh setup.
- Its certified answers meet 1e-8 by the benchmark's plain float64
  reference (``bench_port/reference.py``), in the fresh solver's
  iteration counts.
- Another fine grid or other offsets fall back to a fresh setup, with the
  facade's warning, and ``refresh_counts`` counts it.
- The old hierarchy's loop runners go, the next solve makes new ones; a
  refresh that keeps the old operator (a planted fault) fails the
  reference's check.
- The refresh's phases are ``setup.<label>`` spans under ``amg.refresh``.
- The refresh's graphs (``RefreshGraphs``, eager stand-ins on the CPU)
  give the pinned loop's hierarchy bit for bit, and leave a product that
  keeps other taps, or a failed probe, to the loop.
- A shifted setup whose coarse levels are mass-dominated (no axis scores
  positive stiffness) coarsens on to ``coarse_size``; a coarsest level
  above ``max(coarse_size, MAX_DENSE_ROWS)`` raises instead of densifying;
  unshifted 7- and 27-point hierarchies are those of the rule before it.
"""

import dataclasses
import importlib.util
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import omp_amg_tpu_torch as port
from omp_amg_tpu_torch import Dia
from omp_amg_tpu_torch.amg import hierarchy, structured
from omp_amg_tpu_torch.solvers.graph import graph_stats

N = 16
FLAVORS = ("host", "device")
EXPONENTS = (0, 2, 5, 10)
ROOT = Path(__file__).resolve().parents[1]


def _reference():
    """The benchmark's plain float64 reference, loaded by path."""
    path = ROOT / "bench_port" / "reference.py"
    spec = importlib.util.spec_from_file_location("bench_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()
# poisson3d_7pt's stencil as the benchmark states it ((dz, dy, dx) taps)
TAPS = [(-1, 0, 0), (0, -1, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1), (0, 1, 0),
        (1, 0, 0)]
STENCIL = {"taps": TAPS, "coefficients": [-1.0, -1.0, -1.0, 6.0, -1.0, -1.0,
                                          -1.0]}


def _shifted(a, s: float) -> Dia:
    data = np.array(a.data, np.float64)
    data[list(a.offsets).index(0)] += s
    return Dia(data=data, offsets=a.offsets, dims=a.dims)


def _aniso(n: int, eps: float = 0.01) -> Dia:
    """A 7-point operator with its z coupling ε: z is the weak axis."""
    a = port.poisson3d_7pt(n)
    data = np.array(a.data, np.float64)
    for k, o in enumerate(a.offsets):
        if abs(o) == n * n:
            data[k] *= eps
    data[list(a.offsets).index(0)] = 4.0 + 2.0 * eps
    return Dia(data=data, offsets=a.offsets, dims=a.dims)


def _same(x, y, where="hierarchy"):
    """Bitwise equality of two hierarchies, walked field by field."""
    assert type(x) is type(y), where
    if isinstance(x, torch.Tensor):
        assert x.dtype == y.dtype and x.shape == y.shape, where
        assert torch.equal(x, y), where
    elif isinstance(x, np.ndarray):
        assert x.dtype == y.dtype and np.array_equal(x, y), where
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _same(getattr(x, f.name), getattr(y, f.name), f"{where}.{f.name}")
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(y), where
        for i, (u, v) in enumerate(zip(x, y)):
            _same(u, v, f"{where}[{i}]")
    elif isinstance(x, float):
        assert x == y or (np.isnan(x) and np.isnan(y)), where
    else:
        assert x == y, where


def _solver(a, flavor, params=port.AMGParams(coarse_size=8), **kw):
    return port.AMGSolver(a, params, grid=a.dims, device="cpu",
                          flavor=flavor, **kw)


def _refresh_quietly(solver, a_new):
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # no pattern-guard fallback
        solver.refresh(a_new)


@pytest.mark.parametrize("j", EXPONENTS)
@pytest.mark.parametrize("flavor", FLAVORS)
def test_refresh_is_bitwise_a_fresh_setup(flavor, j):
    a = port.poisson3d_7pt(N)
    solver = _solver(a, flavor, refreshable=True)
    a_new = _shifted(a, 2.0 ** -j)
    _refresh_quietly(solver, a_new)
    fresh_cache = port.StructuredCache()
    fresh = port.amg_setup(a_new, port.AMGParams(coarse_size=8),
                           grid=a.dims, device="cpu", flavor=flavor,
                           cache=fresh_cache)
    # the isotropic operator coarsens every axis at every level, shifted
    # or not (a mass-dominated level too): the cached axes are the fresh
    # setup's, and so is every value
    assert [lv.axes for lv in fresh_cache.levels] == [
        lv.axes for lv in solver._cache.levels]
    _same(solver.hierarchy, fresh)
    assert solver.hierarchy.coarse_chol.shape[0] <= 8
    assert solver.refresh_counts == {"refreshed": 1, "fell_back": 0}


@pytest.mark.parametrize("j", EXPONENTS)
@pytest.mark.parametrize("maker", (port.poisson3d_7pt, port.poisson3d_27pt))
def test_refresh_graphs_give_the_loops_hierarchy(maker, j):
    """The refresh's graphs (their CPU stand-ins), made after a pinned loop:
    a refresh that replays them is bitwise the pinned loop's hierarchy of
    the same operator: planes, dinv, λmax, forms (a ``ConstDia`` fine
    level, ``Dia`` coarse levels) and factor."""
    from omp_amg_tpu_torch.amg.refresh import RefreshGraphs

    a = maker(16)
    solver = _solver(a, "device", refreshable=True)
    cache = solver._cache
    _refresh_quietly(solver, _shifted(a, 1.0))
    assert cache.graphs is None         # made on the card only
    cache.graphs = RefreshGraphs(_shifted(a, 1.0), cache)
    a_new = _shifted(a, 2.0 ** -j)
    _refresh_quietly(solver, a_new)
    assert cache.graph_refreshes == 1
    got = solver.hierarchy
    want = hierarchy._amg_setup_structured(a_new, cache.dims, cache.params,
                                           "cpu", False, cache.steps,
                                           pinned=cache)
    _same(got, want)
    assert isinstance(got.levels[0].a, port.ConstDia)
    assert isinstance(got.levels[1].a, Dia)


@pytest.mark.parametrize("fault", ("keep", "probe"))
def test_refresh_graphs_leave_a_changed_product_to_the_loop(fault):
    """A replay whose product keeps other taps than the graphs were made
    for, or whose probe fails, gives no hierarchy; the refresh then runs
    the pinned loop, whose hierarchy it returns."""
    from omp_amg_tpu_torch.amg.refresh import RefreshGraphs

    a = port.poisson3d_7pt(16)
    solver = _solver(a, "device", refreshable=True)
    cache = solver._cache
    cache.graphs = graphs = RefreshGraphs(a, cache)
    lv = graphs.levels[1]
    graphs.levels[1] = (lv._replace(keep=lv.keep[1:]) if fault == "keep"
                        else lv._replace(probe=torch.tensor([1.0, 1.0])))
    a_new = _shifted(a, 0.25)
    assert graphs.refresh(a_new, cache) is None
    _refresh_quietly(solver, a_new)
    assert cache.graph_refreshes == 0
    want = port.amg_setup(a_new, port.AMGParams(coarse_size=8),
                          grid=a.dims, device="cpu", flavor="device")
    _same(solver.hierarchy, want)


@pytest.mark.parametrize("j", (0, 5))
@pytest.mark.parametrize("flavor", FLAVORS)
def test_refresh_keeps_the_cached_axes(flavor, j):
    """An anisotropic operator: the refresh's hierarchy is the fresh setup of
    the new operator whose axis choice returns the cached axes, level by
    level (the setup's own loop, unpinned)."""
    a = _aniso(N)
    # (the device Galerkin product takes no level of two points along two
    # axes: the loop ends at (16, 2, 2))
    params = port.AMGParams(coarse_size=64)
    solver = _solver(a, flavor, params, refreshable=True)
    cached = [lv.axes for lv in solver._cache.levels]
    assert not all(all(ax) for ax in cached)    # z is held at some level
    a_new = _shifted(a, 2.0 ** -j)
    _refresh_quietly(solver, a_new)
    it = iter(cached)
    steps = hierarchy._STRUCTURED[flavor]._replace(
        axes=lambda *args: next(it))
    fresh = hierarchy._amg_setup_structured(
        a_new, a.dims, params, torch.device("cpu"), False, steps)
    assert next(it, None) is None
    _same(solver.hierarchy, fresh)


@pytest.mark.parametrize("flavor", FLAVORS)
def test_refreshed_answers_meet_the_plain_reference(flavor):
    a = port.poisson3d_7pt(N)
    solver = _solver(a, flavor, refreshable=True)
    config = {"stencil": STENCIL, "n": N}
    rng = np.random.default_rng(24)
    for j in EXPONENTS:
        s = 2.0 ** -j
        a_new = _shifted(a, s)
        _refresh_quietly(solver, a_new)
        b = rng.standard_normal(N ** 3)
        x = solver.solve(b, tol=1e-8)
        assert solver.last_info["certified_f64"]
        rel = REF.rel_residual(config, s, torch.from_numpy(b),
                               torch.as_tensor(x))
        assert rel <= 1e-8, (j, rel)
        fresh = _solver(a_new, flavor)
        fresh.solve(b, tol=1e-8)
        assert solver.last_info["inner_iters"] == \
            fresh.last_info["inner_iters"], j
    assert solver.refresh_counts == {"refreshed": len(EXPONENTS),
                                     "fell_back": 0}


@pytest.mark.parametrize("change", ["offsets", "dims"])
@pytest.mark.parametrize("flavor", FLAVORS)
def test_another_pattern_falls_back_with_the_warning(flavor, change):
    a = port.poisson3d_7pt(N)
    solver = _solver(a, flavor, refreshable=True)
    first = solver._cache
    a_new = (port.poisson3d_27pt(N) if change == "offsets"
             else port.poisson3d_7pt(N - 4))
    with pytest.warns(UserWarning, match="pattern guard"):
        solver.refresh(a_new)
    assert solver.refresh_counts == {"refreshed": 0, "fell_back": 1}
    assert solver._cache is not first
    assert isinstance(solver._cache, port.StructuredCache)
    assert solver._cache.dims == tuple(a_new.dims)
    _same(solver.hierarchy,
          port.amg_setup(a_new, port.AMGParams(coarse_size=8),
                         grid=a_new.dims, device="cpu", flavor=flavor))
    x = solver.solve(port.default_rhs(a_new, seed=1), tol=1e-8)
    assert np.isfinite(x).all() and solver.last_info["rel_residual"] <= 1e-8
    # the new cache refreshes in its turn
    _refresh_quietly(solver, a_new)
    assert solver.refresh_counts == {"refreshed": 1, "fell_back": 1}


def test_refresh_drops_the_old_runners_and_the_solve_makes_new_ones():
    a = port.poisson3d_7pt(N)
    solver = _solver(a, "device", refreshable=True)
    b = port.default_rhs(a, seed=0)
    solver.solve(b, tol=1e-8)
    old = solver.hierarchy
    assert graph_stats(old)
    solver.refresh(_shifted(a, 0.25))
    assert solver.hierarchy is not old
    assert graph_stats(old) == {} and graph_stats(solver.hierarchy) == {}
    solver.solve(b, tol=1e-8)
    assert graph_stats(solver.hierarchy)


def test_the_graph_memory_pool_passes_to_the_refreshed_hierarchy():
    """The pool the old hierarchy's graphs were captured into (a stand-in
    here: a pool needs the card) passes to the refreshed hierarchy; a drop
    without a successor releases it."""
    a = port.poisson3d_7pt(N)
    solver = _solver(a, "device", refreshable=True)
    old = solver.hierarchy
    pool = object()
    old.__dict__["_graph_pool"] = pool
    solver.refresh(_shifted(a, 0.5))
    assert "_graph_pool" not in old.__dict__
    assert solver.hierarchy.__dict__["_graph_pool"] is pool
    from omp_amg_tpu_torch.solvers.graph import drop_graphs

    drop_graphs(solver.hierarchy)
    assert "_graph_pool" not in solver.hierarchy.__dict__


def test_a_stale_refresh_fails_the_reference(monkeypatch):
    """The planted fault: ``refresh`` returns without taking the operator
    in. The solver's own certificate holds (it solved the old operator);
    the plain reference under the new shift does not."""
    a = port.poisson3d_7pt(N)
    solver = _solver(a, "device", refreshable=True)
    monkeypatch.setattr(port.AMGSolver, "refresh", lambda self, a_new: self)
    s = 1.0
    solver.refresh(_shifted(a, s))
    b = port.default_rhs(a, seed=3)
    x = solver.solve(b, tol=1e-8)
    assert solver.last_info["rel_residual"] <= 1e-8
    rel = REF.rel_residual({"stencil": STENCIL, "n": N}, s,
                           torch.as_tensor(b), torch.as_tensor(x))
    assert rel > 1e-2


def test_refresh_phases_are_setup_spans_under_the_facade(monkeypatch):
    monkeypatch.setenv("OMP_AMG_SETUP_TIMERS", "1")
    a = port.poisson3d_7pt(N)
    solver = _solver(a, "device", refreshable=True)
    levels = len(solver.hierarchy.levels)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solver.refresh(_shifted(a, 0.5))
    labels = [label for label, _ in port.last_setup_trace()]
    want = []
    for k in range(levels):
        want += [f"L{k} RAP", f"L{k} lmax", f"L{k} operator form"]
    want.append("coarse factor")
    assert [label.split(" (")[0] for label in labels] == want
    assert labels[2].endswith(")")      # the form the level took
    events = sorted(((e.name, e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.name.startswith(("amg.", "setup."))),
                    key=lambda x: (x[1], -x[2]))
    assert events[0][0] == "amg.refresh"
    assert [e[0] for e in events[1:]] == ["setup." + w for w in want]
    t0, t1 = events[0][1:]
    assert all(t0 <= s and e <= t1 for _, s, e in events[1:])


@pytest.mark.parametrize("s", [1.0, 0.25])
@pytest.mark.parametrize("flavor", FLAVORS)
def test_shifted_setup_coarsens_to_coarse_size(flavor, s):
    a = _shifted(port.poisson3d_7pt(N), s)
    solver = _solver(a, flavor)
    assert solver.hierarchy.coarse_chol.shape[0] <= 8
    assert [lv.a.n_rows for lv in solver.hierarchy.levels] == [4096, 512, 64]
    b = port.default_rhs(a, seed=2)
    x = solver.solve(b, tol=1e-8)
    assert solver.last_info["rel_residual"] <= 1e-8
    rel = REF.rel_residual({"stencil": STENCIL, "n": N}, s,
                           torch.as_tensor(b), torch.as_tensor(x))
    assert rel <= 1e-8


def test_no_stiffness_coarsens_every_axis_longer_than_two():
    offsets = [-16, -4, -1, 0, 1, 4, 16]
    mass = [0.25, 0.25, 0.25, 3.0, 0.25, 0.25, 0.25]    # all positive
    assert structured.strong_axes_from_values(
        offsets, mass, (4, 4, 4), 0.25) == (True, True, True)
    assert structured.strong_axes_from_values(
        offsets, mass, (2, 4, 4), 0.25) == (False, True, True)


@pytest.mark.parametrize("flavor", FLAVORS)
def test_a_densify_above_the_bound_raises(flavor):
    """A 1D coupling along x on a (4096, 4) grid: x stops at 2 points, y is
    never strong, and the loop ends at 8,192 rows: the setup raises rather
    than allocate a 512 MiB dense coarse operator."""
    dims = (4096, 4)
    x = np.arange(4096 * 4) % 4
    data = np.stack([-1.0 * (x > 0), np.full(x.shape, 2.0),
                     -1.0 * (x < 3)])
    a = Dia(data=data, offsets=(-1, 0, 1), dims=dims)
    assert hierarchy.MAX_DENSE_ROWS < 8192
    with pytest.raises(ValueError, match="8192 rows"):
        port.amg_setup(a, port.AMGParams(), grid=dims, device="cpu",
                       flavor=flavor)


def _parent_rule(offsets, values, dims, theta):
    """The axis rule before the mass-dominated case: no axis when no axis
    scores positive stiffness."""
    values = np.asarray(values, np.float64)
    deltas = structured.axis_deltas(offsets, dims)
    c = np.array([max(0.0, float(np.sum(-values * deltas[:, ax] ** 2)))
                  for ax in range(len(dims))])
    if c.max() <= 0:
        return tuple(False for _ in dims)
    return tuple(bool(c[ax] >= theta * c.max() and dims[ax] > 2)
                 for ax in range(len(dims)))


@pytest.mark.parametrize("flavor", FLAVORS)
@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("maker", ["poisson3d_7pt", "poisson3d_27pt"])
def test_unshifted_hierarchies_are_unchanged(maker, n, flavor, monkeypatch):
    a = getattr(port, maker)(n)
    cache = port.StructuredCache()
    new = port.amg_setup(a, port.AMGParams(), grid=(n,) * 3, device="cpu",
                         flavor=flavor, cache=cache)
    monkeypatch.setattr(structured, "strong_axes_from_values", _parent_rule)
    monkeypatch.setattr(hierarchy, "strong_axes_from_values", _parent_rule)
    old = port.amg_setup(a, port.AMGParams(), grid=(n,) * 3, device="cpu",
                         flavor=flavor)
    _same(new, old)
    assert [lv.axes for lv in cache.levels] == [(True,) * 3] * len(
        new.levels)
    assert new.coarse_chol.shape[0] <= 100
