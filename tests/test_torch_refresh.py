"""The port's value-only refresh (``amg/refresh.py``, ``AMGSolver.refresh``)
against its own fresh setups and against the reference's refresh, on the
CPU.

- ``amg_refresh`` on the reference's refresh configs (``tests/
  test_refresh.py``: 7-pt 20³, 2D 48², aniso 48² at θ = 0.5, 27-pt 12³
  Chebyshev): the cold (×2) and the warm (×4) refresh equal the port's fresh
  setup of the same operator, and the reference's refresh, to f32 roundoff
  (rtol 2e-6 on P, R, A_c and dinv);
- the non-dyadic ×1.7 change, whose ext+i near-ties flip: the pinned rows
  equal the reference's, the index tensors stay the cached ones, the f32
  residue on A_c's eliminated entries stays under the 1e-7 guard and the
  solve converges;
- every guard raises ``PatternChangedError``: a strength change, a CSR
  operator whose ``indptr`` alone moved, another Dia; the cache refuses
  structured setups;
- the facade: exact scaling gives x / 4, a pattern change warns and falls
  back to a fresh setup, and the certified counts after a refresh equal the
  reference's refreshed solve's;
- ``rap="probe"`` with a cache refreshes A_c's values on the host, as the
  reference does;
- ``native.spgemm_numeric``/``perm_gather`` and ``galerkin_product``'s
  recorded patterns against the reference's.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import omp_amg_tpu as ref
from omp_amg_tpu import native as ref_native
from omp_amg_tpu.amg import host_setup as ref_hs
from omp_amg_tpu.amg.hierarchy import amg_setup as ref_setup
from omp_amg_tpu.amg.params import AMGParams as RefParams
from omp_amg_tpu.amg.refresh import SetupCache as RefCache
from omp_amg_tpu.amg.refresh import amg_refresh as ref_refresh
from omp_amg_tpu.ops.rap import galerkin_product as ref_galerkin
from omp_amg_tpu.solvers.ir import solve_ir as ref_solve_ir
from omp_amg_tpu.sparse.formats import dia_to_scipy as ref_dia_to_scipy
from omp_amg_tpu.sparse.formats import ell_to_scipy

import omp_amg_tpu_torch as port
from omp_amg_tpu_torch import native
from omp_amg_tpu_torch.amg import host_setup as hs
from omp_amg_tpu_torch.amg import refresh
from omp_amg_tpu_torch.ops.rap import galerkin_product
from omp_amg_tpu_torch.sparse.formats import (
    Csr, Dia, dia_to_scipy, ell_planes_from_dia,
)
from omp_amg_tpu_torch.utils.io import csr_to_scipy

torch.set_num_threads(2)

RTOL = 2e-6        # refreshed against fresh or reference: f32 roundoff
ATOL = 1e-7        # for entries that cancel to ~0 (as the reference's test)

# the reference's refresh configs (tests/test_refresh.py), with the
# reference generator's backend of each: the device backend (None) rounds
# the values to f32, so the port's operator is rounded to f32 too (exact
# for the Poisson stencils; aniso's values are not f32-exact)
CONFIGS = {
    "7pt_20": ("poisson3d_7pt", 20, dict(coarsening="pmis"), None),
    "2d5pt_48": ("poisson2d_5pt", 48, dict(coarsening="pmis"), None),
    "aniso_48_theta05": ("aniso2d_9pt", 48,
                         dict(coarsening="pmis", theta=0.5), None),
    "27pt_12_cheby": ("poisson3d_27pt", 12,
                      dict(coarsening="pmis", smoother="chebyshev"), "numpy"),
}


def _scale(a, s):
    return Dia(data=a.data * s, offsets=a.offsets, dims=a.dims)


def _ref_scale(a, s):
    return ref.Dia(data=np.asarray(a.data) * s, offsets=a.offsets,
                   dims=a.dims)


def _port_sp(op):
    return dia_to_scipy(op) if isinstance(op, Dia) else csr_to_scipy(op)


def _ref_sp(op):
    if isinstance(op, ref.Dia):
        return ref_dia_to_scipy(op)
    return ell_to_scipy(op)


def _same(got, want, what, rtol=RTOL):
    got, want = sp.csr_matrix(got), sp.csr_matrix(want)
    for m in (got, want):
        m.eliminate_zeros()
        m.sort_indices()
    np.testing.assert_array_equal(got.indptr, want.indptr, err_msg=what)
    np.testing.assert_array_equal(got.indices, want.indices, err_msg=what)
    np.testing.assert_allclose(got.data, want.data, rtol=rtol, atol=ATOL,
                               err_msg=what)


def _same_hier(got, want):
    """Two port hierarchies: the same structure (index tensors equal) and
    values to f32 roundoff."""
    assert len(got.levels) == len(want.levels)
    for l, (lg, lw) in enumerate(zip(got.levels, want.levels)):
        assert type(lg.a) is type(lw.a)
        np.testing.assert_allclose(lg.dinv, lw.dinv, rtol=RTOL)
        np.testing.assert_allclose(lg.lmax, lw.lmax, rtol=1e-4)
        for name in ("a", "p", "r"):
            og, ow = getattr(lg, name), getattr(lw, name)
            if isinstance(ow, Csr):
                assert torch.equal(og.indptr, ow.indptr)
                assert torch.equal(og.indices, ow.indices)
                assert og.vals.dtype == ow.vals.dtype
            _same(_port_sp(og), _port_sp(ow), f"L{l} {name}")
    np.testing.assert_allclose(got.coarse_chol.numpy(),
                               want.coarse_chol.numpy(), rtol=1e-5,
                               atol=1e-8)


def _same_as_reference(got, want):
    """A port hierarchy against the reference's: P, R, A_c and dinv."""
    assert len(got.levels) == len(want.levels)
    for l, (lg, lw) in enumerate(zip(got.levels, want.levels)):
        np.testing.assert_allclose(lg.dinv, np.asarray(lw.dinv), rtol=RTOL)
        for name in ("a", "p", "r"):
            _same(_port_sp(getattr(lg, name)), _ref_sp(getattr(lw, name)),
                  f"L{l} {name}")
    np.testing.assert_allclose(got.coarse_chol.numpy(),
                               np.asarray(want.coarse_chol), rtol=1e-5,
                               atol=1e-8)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_refresh_matches_fresh_and_reference(name):
    gen, n, kw, backend = CONFIGS[name]
    a = getattr(port, gen)(n)
    if backend is None:
        a = Dia(data=a.data.astype(np.float32).astype(np.float64),
                offsets=a.offsets, dims=a.dims)
    prm = port.AMGParams(**kw)
    cache = port.SetupCache()
    port.amg_setup(a, prm, device="cpu", cache=cache)
    a_j = getattr(ref, gen)(n, backend=backend) if backend else \
        getattr(ref, gen)(n)
    cache_j = RefCache()
    ref_setup(a_j, RefParams(**kw), cache=cache_j)
    # ×2 takes the cold path, ×4 the warm one; both keep f32-exact values
    # f32-exact (the reference's warm path rounds the fine operator to
    # f32), so no truncation tie flips and every setup agrees
    for s in (2.0, 4.0):
        h = port.amg_refresh(_scale(a, s), cache)
        _same_hier(h, port.amg_setup(_scale(a, s), prm, device="cpu"))
        _same_as_reference(h, ref_refresh(_ref_scale(a_j, s), cache_j))


def test_refresh_pinned_pattern_on_tie_flips():
    """×1.7 flips ext+i truncation near-ties: the refresh pins the cached
    pattern (reference's contract), equals the reference's refresh, keeps
    the cached index tensors, and solves as a fresh setup does."""
    a = port.poisson3d_7pt(20)
    prm = port.AMGParams(coarsening="pmis")
    cache = port.SetupCache()
    h0 = port.amg_setup(a, prm, device="cpu", cache=cache)
    a2 = _scale(a, 1.7)
    h = port.amg_refresh(a2, cache)
    for l0, ln in zip(h0.levels, h.levels):
        for name in ("p", "r"):
            assert getattr(ln, name).indices is getattr(l0, name).indices
            assert getattr(ln, name).indptr is getattr(l0, name).indptr
        if isinstance(l0.a, Csr):
            assert ln.a.indices is l0.a.indices
    # the reference's numpy Dia takes the DIA-layout planes the port's
    # setup uses, which decide the ties (its device Dia, CSR layout); this
    # is its cold path, which keeps the f64 values
    cache_j = RefCache()
    a_j = ref.poisson3d_7pt(20, backend="numpy")
    ref_setup(a_j, RefParams(coarsening="pmis"), cache=cache_j)
    _same_as_reference(h, ref_refresh(_ref_scale(a_j, 1.7), cache_j))

    b = port.default_rhs(a2, seed=5)
    res = port.amg_pcg(h.levels[0].a, b, h, tol=1e-6, maxiter=100)
    hf = port.amg_setup(a2, prm, device="cpu")
    res_f = port.amg_pcg(hf.levels[0].a, b, hf, tol=1e-6, maxiter=100)
    assert abs(res.iters - res_f.iters) <= 1
    b64 = b.numpy().astype(np.float64)
    x = res.x.numpy().astype(np.float64)
    assert (np.linalg.norm(b64 - dia_to_scipy(a2) @ x)
            / np.linalg.norm(b64)) < 5e-5


def test_extpi_pinned_rows_matches_reference():
    """The pinned ext+i rows on the ×1.7 operator's planes, pinned to the
    ×1 pattern: bitwise the reference's function."""
    a = port.poisson3d_7pt(12)
    col, val, _ = ell_planes_from_dia(a, dtype=np.float32)
    mask = hs.strength_mask_host(col, val, 0.25)
    state = hs.pmis_host(col, mask)
    cmap = np.cumsum(state == hs.CPOINT) - 1
    nc = int((state == hs.CPOINT).sum())
    p_col, p_val = hs.extpi_interpolation(col, val, mask, state, cmap, nc)
    val2 = (val.astype(np.float64) * 1.7).astype(np.float32)
    rows = np.flatnonzero(state == hs.FPOINT)[::3]   # as the refresh: F rows
    got = hs.extpi_pinned_rows(col, val2, mask, state, cmap, nc, rows,
                               p_col, p_val != 0)
    want = ref_hs.extpi_pinned_rows(col, val2, mask, state, cmap, nc, rows,
                                    p_col, p_val != 0)
    np.testing.assert_array_equal(got, want)


def test_x17_stays_under_the_dropped_guard(monkeypatch):
    """The f32 residue a ×1.7 change leaves on A_c entries the setup
    eliminated (24³: ~1.4e-8 of max|A_c|) passes the 1e-7 guard, and a
    guard below the residue trips: the guard is live, not vacuous."""
    a = port.poisson3d_7pt(24)
    prm = port.AMGParams(coarsening="pmis")
    cache = port.SetupCache()
    port.amg_setup(a, prm, device="cpu", cache=cache)
    assert refresh.DROPPED_TOL == 1e-7
    port.amg_refresh(_scale(a, 1.7), cache)          # cold
    port.amg_refresh(_scale(a, 1.7 * 1.7), cache)    # warm
    monkeypatch.setattr(refresh, "DROPPED_TOL", 1e-10)
    with pytest.raises(port.PatternChangedError, match="eliminated"):
        port.amg_refresh(_scale(a, 1.7), cache)


def test_refresh_detects_pattern_change():
    a = port.poisson2d_5pt(32)
    cache = port.SetupCache()
    port.amg_setup(a, port.AMGParams(coarsening="pmis"), device="cpu",
                   cache=cache)
    data = a.data.copy()
    for i, o in enumerate(a.offsets):
        if abs(o) == 1:
            data[i] *= 1e-6
    with pytest.raises(port.PatternChangedError):
        port.amg_refresh(Dia(data=data, offsets=a.offsets, dims=a.dims),
                         cache)
    # another banded operator (other offsets), or CSR input for a Dia cache
    with pytest.raises(port.PatternChangedError, match="offsets"):
        port.amg_refresh(port.poisson2d_5pt(16, 64), cache)
    with pytest.raises(port.PatternChangedError, match="without Dia"):
        port.amg_refresh(dia_to_scipy(a), cache)


def test_refresh_warm_csr_guard_checks_indptr():
    """Identical concatenated column indices with a moved row boundary are
    caught (the reference's ADVICE r4 case), on the warm path."""
    a0 = dia_to_scipy(port.poisson2d_5pt(24))
    cache = port.SetupCache()
    port.amg_setup(a0, port.AMGParams(coarsening="pmis"), device="cpu",
                   cache=cache)
    a_sp = (a0 * 2.0).tocsr()
    a_sp.sort_indices()
    port.amg_refresh(a_sp, cache)          # cold
    h = port.amg_refresh(a_sp * 1.5, cache)  # warm control
    assert isinstance(h.levels[0].a, Csr)
    _same(csr_to_scipy(h.levels[0].a), a_sp * 1.5, "L0 A")
    bad = a_sp.copy()
    ip = bad.indptr.copy()
    ip[1] -= 1   # the last entry of row 0 becomes the head of row 1
    bad.indptr = ip
    bad.has_sorted_indices = True
    with pytest.raises(port.PatternChangedError, match="CSR pattern changed"):
        port.amg_refresh(bad, cache)


def test_refresh_csr_input_any_order():
    """A scipy operator in any order (unsorted rows, a duplicate, a stored
    zero) sets up in canonical CSR order and refreshes from any order too;
    a value that becomes exactly zero is a pattern change."""
    a0 = dia_to_scipy(port.poisson2d_5pt(24))
    coo = a0.tocoo()
    order = np.random.default_rng(1).permutation(coo.nnz)
    vals = coo.data[order].copy()
    vals[(coo.row[order] == 3) & (coo.col[order] == 3)] -= 1.0
    rows = np.r_[coo.row[order], 3, 5]     # + a duplicate of (3, 3) and
    cols = np.r_[coo.col[order], 3, 40]    # a stored zero at (5, 40)
    vals = np.r_[vals, 1.0, 0.0]

    def messy(s):
        return sp.coo_matrix((vals * s, (rows, cols)), shape=a0.shape)

    prm = port.AMGParams(coarsening="pmis")
    cache = port.SetupCache()
    h0 = port.amg_setup(messy(1.0), prm, device="cpu", cache=cache)
    _same_hier(h0, port.amg_setup(a0, prm, device="cpu"))
    h = port.amg_refresh(messy(2.0), cache)
    _same_hier(h, port.amg_setup(a0 * 2.0, prm, device="cpu"))
    bad = a0.copy()
    bad.data[1] = 0.0          # row 0's first off-diagonal entry
    with pytest.raises(port.PatternChangedError, match="CSR pattern"):
        port.amg_refresh(bad, cache)


def test_cache_rejects_structured_setups():
    a = port.poisson3d_7pt(16)
    with pytest.raises(ValueError):
        port.amg_setup(a, port.AMGParams(coarsening="structured"),
                       grid=(16,) * 3, device="cpu", cache=port.SetupCache())
    # and a structured cache the PMIS setups
    with pytest.raises(ValueError):
        port.amg_setup(a, port.AMGParams(coarsening="pmis"), device="cpu",
                       cache=port.StructuredCache())
    # a refreshable structured solver records the structured cache
    s = port.AMGSolver(a, port.AMGParams(), grid=(16,) * 3, device="cpu",
                       refreshable=True)
    assert isinstance(s._cache, port.StructuredCache)
    with pytest.raises(ValueError, match="refreshable"):
        port.AMGSolver(a, port.AMGParams(coarsening="pmis"),
                       device="cpu").refresh(a)


def test_facade_refresh():
    a = port.poisson3d_7pt(16)
    s = port.AMGSolver(a, port.AMGParams(coarsening="pmis"), device="cpu",
                       refreshable=True)
    b = port.default_rhs(a, seed=0)
    x1 = s.solve(b, tol=1e-8)
    s.solve(b, tol=1e-8)
    assert s._a_host is not None
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # no pattern-guard fallback
        s.refresh(_scale(a, 4.0))
    assert s._a_host is None and s._a_f64 is None
    x2 = s.solve(b, tol=1e-8)
    # exact scaling: x2 == x1 / 4 for the same right-hand side
    np.testing.assert_allclose(x2, x1 / 4.0, rtol=1e-6, atol=1e-9)
    assert s.last_info["certified_f64"]
    assert s.last_info["rel_residual"] <= 1e-8


def test_facade_refresh_falls_back_on_pattern_change():
    a = port.poisson2d_5pt(32)
    s = port.AMGSolver(a, port.AMGParams(coarsening="pmis"), device="cpu",
                       refreshable=True)
    first = s._cache
    data = a.data.copy()
    for i, o in enumerate(a.offsets):
        if abs(o) == 1:
            data[i] *= 1e-6
    a_bad = Dia(data=data, offsets=a.offsets, dims=a.dims)
    with pytest.warns(UserWarning, match="pattern guard"):
        s.refresh(a_bad)
    assert s._cache is not first and s._cache.hier is s.hierarchy
    b = port.default_rhs(a_bad, seed=1)
    x = s.solve(b, tol=1e-8)
    b64 = b.numpy().astype(np.float64)
    assert (np.linalg.norm(b64 - dia_to_scipy(a_bad) @ x)
            / np.linalg.norm(b64)) <= 1e-7


@pytest.mark.parametrize("s", [1.7, 0.35])
def test_certified_counts_after_refresh_match_reference(s):
    """The certified solve on a refreshed hierarchy: per-outer inner counts
    and the outer count equal the reference's refreshed solve's."""
    n = 16
    b = np.asarray(ref.default_rhs(ref.poisson3d_7pt(n), seed=0),
                   np.float64)
    solver_j = ref.AMGSolver(ref.poisson3d_7pt(n, backend="numpy"),
                             RefParams(coarsening="pmis"), refreshable=True)
    solver_j.refresh(_ref_scale(ref.poisson3d_7pt(n, backend="numpy"), s))
    res_j = ref_solve_ir(solver_j.a_host, b, solver_j.a, solver_j.hierarchy,
                         tol=1e-8, maxiter=500)

    a = port.poisson3d_7pt(n)
    solver = port.AMGSolver(a, port.AMGParams(coarsening="pmis"),
                            device="cpu", refreshable=True)
    solver.refresh(_scale(a, s))
    x = solver.solve(torch.from_numpy(b.astype(np.float32)), tol=1e-8)
    info = solver.last_info
    assert info["inner_iters"] == list(res_j.inner_iters)
    assert info["outer_iters"] == res_j.outer_iters
    assert info["rel_residual"] <= 1e-8
    assert (np.linalg.norm(b - dia_to_scipy(_scale(a, s)) @ x)
            / np.linalg.norm(b)) <= 1e-8


def test_refresh_with_probe_values():
    """A ``rap="probe"`` setup records the host product's pattern; its
    refresh computes A_c's values on the host (as the reference's), so it
    equals a fresh host-valued setup to f32 roundoff."""
    a = port.poisson3d_7pt(12)
    cache = port.SetupCache()
    port.amg_setup(a, port.AMGParams(coarsening="pmis", rap="probe"),
                   device="cpu", cache=cache)
    h = port.amg_refresh(_scale(a, 2.0), cache)
    hf = port.amg_setup(_scale(a, 2.0), port.AMGParams(coarsening="pmis"),
                        device="cpu")
    assert len(h.levels) == len(hf.levels)
    for lg, lw in zip(h.levels, hf.levels):
        for name in ("a", "p", "r"):
            _same(_port_sp(getattr(lg, name)), _port_sp(getattr(lw, name)),
                  name)
    assert port.cache_nbytes(cache) > 0


def test_numeric_spgemm_and_gather_match_reference():
    rng = np.random.default_rng(0)
    a = sp.random(60, 50, density=0.1, random_state=rng, format="csr")
    b = sp.random(50, 40, density=0.1, random_state=rng, format="csr")
    for m in (a, b):
        m.sort_indices()
    c = native.spgemm(a, b)
    c.sort_indices()

    def pat(m):
        return (m.indptr.astype(np.int64), m.indices.astype(np.int32),
                m.shape[1])

    got = native.spgemm_numeric(pat(a), a.data, pat(b), b.data, pat(c),
                                check=True)
    want = ref_native.spgemm_numeric(pat(a), a.data, pat(b), b.data, pat(c))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, (a @ b).tocsr().toarray()[
        np.repeat(np.arange(60), np.diff(c.indptr)), c.indices], rtol=1e-14)
    small = sp.csr_matrix(c[:, :20])
    small.resize(c.shape)
    with pytest.raises(ValueError, match="not contained"):
        native.check_spgemm_containment(pat(a), pat(b), pat(small))
    perm = rng.permutation(500).astype(np.int32)
    x = rng.standard_normal(500)
    np.testing.assert_array_equal(native.perm_gather(perm, x), x[perm])
    np.testing.assert_array_equal(native.perm_gather(perm.astype(np.int64),
                                                     x),
                                  ref_native.perm_gather(perm, x))
    # the kernels read without bounds checks: their inputs are checked
    with pytest.raises(IndexError):
        native.perm_gather(perm, x[:-1])
    with pytest.raises(ValueError, match="sizes"):
        native.spgemm_numeric(pat(a), a.data[:-1], pat(b), b.data, pat(c))


def test_galerkin_patterns_match_reference():
    a_sp = dia_to_scipy(port.poisson3d_7pt(10))
    col, val, _ = ell_planes_from_dia(port.poisson3d_7pt(10))
    mask = hs.strength_mask_host(col, val, 0.25)
    state = hs.pmis_host(col, mask)
    cmap = np.cumsum(state == hs.CPOINT) - 1
    p_col, p_val = hs.extpi_interpolation(col, val, mask, state, cmap,
                                          int(cmap[-1]) + 1)
    from omp_amg_tpu_torch.sparse.formats import ell_planes_to_scipy

    p_sp = ell_planes_to_scipy(p_col, p_val, int(cmap[-1]) + 1)
    got, want = {}, {}
    ac = galerkin_product(a_sp, p_sp, patterns_out=got)
    ac_j = ref_galerkin(a_sp, p_sp, patterns_out=want)
    assert (abs(ac - ac_j) > 0).nnz == 0
    assert sorted(got) == sorted(want) == ["acs", "ap"]
    for k in got:
        for g, w in zip(got[k][:2], want[k][:2]):
            np.testing.assert_array_equal(g, w)
        assert got[k][2] == want[k][2]
