"""The port's structured (semicoarsening) host setup against the reference's
``amg_setup(a, AMGParams(), grid=dims, keep_host=True)``: per level the
grid dims and coarsened axes, the operator form (``ConstDia`` or ``Dia``),
the coarse offsets, the coarse f64 operators (rtol 1e-12), ``dinv`` (equal
as f32), ``lmax`` (rtol 1e-6) and the coarse Cholesky factor (1e-6); plus
the grid transfers against the reference's CPU slice path, bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omp_amg_tpu as ref
from omp_amg_tpu.amg import structured as ref_structured
from omp_amg_tpu.amg.hierarchy import amg_setup as ref_setup
from omp_amg_tpu.amg.params import AMGParams as RefParams

import omp_amg_tpu_torch as port
from omp_amg_tpu_torch.amg import structured
from omp_amg_tpu_torch.sparse.formats import ConstDia, Dia

torch.set_num_threads(2)

CONFIGS = {
    "7pt_16": (lambda m: m.poisson3d_7pt(16, **m.kw), (16, 16, 16)),
    "7pt_32": (lambda m: m.poisson3d_7pt(32, **m.kw), (32, 32, 32)),
    "7pt_24": (lambda m: m.poisson3d_7pt(24, **m.kw), (24, 24, 24)),
    "5pt_64": (lambda m: m.poisson2d_5pt(64, **m.kw), (64, 64)),
    "aniso9pt_64": (lambda m: m.aniso2d_9pt(64, **m.kw), (64, 64)),
}


class _Ref:
    """The reference's generators, on numpy f64 data like the port's."""
    kw = {"backend": "numpy"}

    def __getattr__(self, name):
        return getattr(ref, name)


class _Port:
    kw = {}

    def __getattr__(self, name):
        return getattr(port, name)


@pytest.fixture(scope="module", params=list(CONFIGS))
def setups(request):
    make, dims = CONFIGS[request.param]
    hier_j, ops_j = ref_setup(make(_Ref()), RefParams(), grid=dims,
                              keep_host=True)
    hier_t, host = port.amg_setup(make(_Port()), port.AMGParams(), grid=dims,
                                  device="cpu", keep_host=True)
    return request.param, hier_j, ops_j, hier_t, host


def test_levels_dims_and_axes(setups):
    _, hier_j, _, hier_t, _ = setups
    assert hier_t.n_levels == hier_j.n_levels
    for lt, lj in zip(hier_t.levels, hier_j.levels):
        for got, want in ((lt.p, lj.p), (lt.r, lj.r)):
            assert type(got).__name__ == type(want).__name__
            assert got.fine_shape == want.fine_shape
            assert got.coarse_shape == want.coarse_shape
            assert got.coarsened == want.coarsened
    assert hier_t.coarse_chol.shape == np.asarray(hier_j.coarse_chol).shape


def test_operator_forms_and_offsets(setups):
    name, hier_j, _, hier_t, _ = setups
    forms = [type(lv.a).__name__ for lv in hier_t.levels]
    assert forms == [type(lv.a).__name__ for lv in hier_j.levels]
    assert (forms[0] == "ConstDia") == (name in ("7pt_16", "7pt_32"))
    for lt, lj in zip(hier_t.levels, hier_j.levels):
        assert tuple(lt.a.offsets) == tuple(lj.a.offsets)
        if isinstance(lt.a, ConstDia):
            assert lt.a.taps == lj.a.taps and lt.a.coeffs == lj.a.coeffs
            assert isinstance(lt.s, float)
        else:
            assert isinstance(lt.a, Dia)
            np.testing.assert_array_equal(lt.a.data.float().numpy(),
                                          np.asarray(lj.a.data, np.float32))


def test_coarse_operators_match(setups):
    _, _, ops_j, _, host = setups
    assert len(host.ops) == len(ops_j)
    for got, want in zip(host.ops, ops_j):
        got, want = got.tocsr(), want.tocsr()
        got.sort_indices()
        want.sort_indices()
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.data, want.data, rtol=1e-12, atol=0)


def test_dinv_lmax_and_coarse_factor_match(setups):
    _, hier_j, _, hier_t, _ = setups
    for lt, lj in zip(hier_t.levels, hier_j.levels):
        np.testing.assert_array_equal(lt.dinv, np.asarray(lj.dinv))
        np.testing.assert_allclose(lt.lmax, float(np.asarray(lj.lmax)),
                                   rtol=1e-6, atol=0)
    np.testing.assert_allclose(hier_t.coarse_chol.numpy(),
                               np.asarray(hier_j.coarse_chol), rtol=1e-6,
                               atol=1e-6)


SHAPES = [((9, 6, 7), (5, 6, 4), (True, False, True)),
          ((16, 16, 16), (8, 8, 8), (True, True, True)),
          ((3, 5, 2), (2, 3, 2), (True, True, False)),
          ((64, 64), (32, 64), (True, False)),
          ((7, 33), (4, 17), (True, True)),
          ((2, 9), (2, 5), (False, True))]


@pytest.mark.parametrize("fine,coarse,axes", SHAPES)
def test_transfers_bitwise_equal_reference_slices(fine, coarse, axes):
    rng = np.random.default_rng(4)
    kw = dict(fine_shape=fine, coarse_shape=coarse, coarsened=axes)
    xc = rng.standard_normal(int(np.prod(coarse))).astype(np.float32)
    xf = rng.standard_normal(int(np.prod(fine))).astype(np.float32)
    p, r = structured.GridProlong(**kw), structured.GridRestrict(**kw)
    want_p = ref_structured.apply_prolong(ref_structured.GridProlong(**kw),
                                          jnp.asarray(xc))
    want_r = ref_structured.apply_restrict(ref_structured.GridRestrict(**kw),
                                           jnp.asarray(xf))
    got_p = structured.apply_prolong(p, torch.from_numpy(xc))
    got_r = structured.apply_restrict(r, torch.from_numpy(xf))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    # the materialized P (exact sparse fallback) is the same operator
    pm = structured.prolong_to_scipy(p)
    np.testing.assert_allclose(pm @ xc.astype(np.float64), got_p.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pm.T @ xf.astype(np.float64), got_r.numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dims,radii,kernel", [
    ((32, 32), (4, 4), "DIA"),               # 81 diagonals > 64
    ((4, 8, 32), (1, 2, 2), "stencil"),      # a constant 75-tap stencil > 27
])
def test_setup_refuses_levels_beyond_the_kernel_limits(dims, radii, kernel):
    taps = {tuple(i - r for i, r in zip(t, radii)): -1.0
            for t in np.ndindex(*(2 * r + 1 for r in radii))}
    taps[(0,) * len(dims)] = float(len(taps))
    a = port.stencil_to_dia(dims, taps)
    with pytest.raises(ValueError, match=f"the {kernel} kernel"):
        port.amg_setup(a, port.AMGParams(), grid=dims, device="cpu")


def test_structured_needs_a_matching_grid():
    a = port.poisson3d_7pt(8)
    with pytest.raises(ValueError):
        port.amg_setup(a, port.AMGParams(coarsening="structured"))
    with pytest.raises(ValueError):
        port.amg_setup(a, port.AMGParams(), grid=(8, 8, 4))
    # "auto" without a grid is the classical (PMIS) setup
    hier = port.amg_setup(a, port.AMGParams(), device="cpu")
    assert not isinstance(hier.levels[0].p, structured.GridProlong)
