"""The port's classical (PMIS) host setup against the reference's
``amg_setup(a, AMGParams(coarsening="pmis"), keep_host=True)`` on the 3D
7-point Poisson problem: per level the C/F split (exact), P and A_c
(same pattern, values within rtol 1e-12), dinv and lmax (rtol 1e-12), and
the level sizes; plus the device forms the setup hands to the kernels.
"""

import numpy as np
import pytest
import torch

import omp_amg_tpu as ref
from omp_amg_tpu.amg.hierarchy import amg_setup as ref_setup
from omp_amg_tpu.amg.hierarchy import hierarchy_stats as ref_stats
from omp_amg_tpu.amg.params import AMGParams as RefParams
from omp_amg_tpu.amg.refresh import SetupCache
from omp_amg_tpu.sparse.formats import ell_to_scipy

import omp_amg_tpu_torch as port
from omp_amg_tpu_torch.amg.hierarchy import jacobi_scale
from omp_amg_tpu_torch.sparse.formats import Csr, Dia

torch.set_num_threads(2)

RTOL = 1e-12


@pytest.fixture(scope="module", params=[16, 24])
def setups(request):
    n = request.param
    cache = SetupCache()
    hier_j, ops_j = ref_setup(ref.poisson3d_7pt(n, backend="numpy"),
                              RefParams(coarsening="pmis"), keep_host=True,
                              cache=cache)
    a = port.poisson3d_7pt(n)
    hier_t, host = port.amg_setup(a, port.AMGParams(coarsening="pmis"),
                                  device="cpu", keep_host=True)
    return a, hier_j, ops_j, cache, hier_t, host


def _same_csr(got, want):
    got, want = got.tocsr(), want.tocsr()
    got.sort_indices()
    want.sort_indices()
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=RTOL, atol=0)


def test_level_count_and_sizes(setups):
    _, hier_j, ops_j, _, hier_t, host = setups
    assert hier_t.n_levels == hier_j.n_levels
    assert port.hierarchy_stats(hier_t, host) == ref_stats(hier_j, ops_j)


def test_cf_split_is_identical(setups):
    _, hier_j, _, cache, hier_t, host = setups
    assert len(host.states) == len(cache.levels) == len(hier_j.levels)
    for got, lc in zip(host.states, cache.levels):
        np.testing.assert_array_equal(got, lc["state"])


def test_prolongation_matches(setups):
    _, hier_j, _, _, hier_t, host = setups
    for l, lv in enumerate(hier_j.levels):
        _same_csr(host.p[l], ell_to_scipy(lv.p))


def test_coarse_operators_match(setups):
    _, _, ops_j, _, _, host = setups
    assert len(host.ops) == len(ops_j)
    for got, want in zip(host.ops, ops_j):
        _same_csr(got, want)


def test_dinv_and_lmax_match(setups):
    _, hier_j, _, _, hier_t, _ = setups
    for lt, lj in zip(hier_t.levels, hier_j.levels):
        np.testing.assert_allclose(lt.dinv, np.asarray(lj.dinv),
                                   rtol=RTOL, atol=0)
        np.testing.assert_allclose(lt.lmax, float(np.asarray(lj.lmax)),
                                   rtol=RTOL, atol=0)


def test_device_forms(setups):
    """Fine A stays banded (lossless bf16); coarse A, P and R are f32 CSR
    with the f32-rounded host values; s = ω·dinv; the coarse factor is the
    reference's."""
    a, hier_j, _, _, hier_t, host = setups
    a0 = hier_t.levels[0].a
    assert isinstance(a0, Dia) and a0.data.dtype == torch.bfloat16
    np.testing.assert_array_equal(a0.data.float().numpy(), a.data)
    for l, lv in enumerate(hier_t.levels):
        for op, want in ((lv.p, host.p[l]), (lv.r, host.p[l].T.tocsr())):
            assert isinstance(op, Csr) and op.vals.dtype == torch.float32
            np.testing.assert_array_equal(op.indptr.numpy(), want.indptr)
            np.testing.assert_array_equal(op.vals.numpy(),
                                          want.data.astype(np.float32))
        if l:
            assert isinstance(lv.a, Csr)
            np.testing.assert_array_equal(
                lv.a.vals.numpy(), host.ops[l].data.astype(np.float32))
        np.testing.assert_array_equal(
            lv.s.numpy(), jacobi_scale(lv.dinv, lv.lmax,
                                       hier_t.params))
    np.testing.assert_allclose(hier_t.coarse_chol.numpy(),
                               np.asarray(hier_j.coarse_chol), rtol=1e-6,
                               atol=1e-6)


def test_unported_parameters_raise():
    a = port.poisson3d_7pt(8)
    # every smoother, cycle and coarse solve of the reference sets up ...
    for kw in (dict(smoother="chebyshev"), dict(cycle="w"),
               dict(smoother="l1jacobi"), dict(coarse_solver="inv")):
        assert port.amg_setup(a, port.AMGParams(coarsening="pmis", **kw),
                              device="cpu").levels
    # ... values outside them do not
    for kw in (dict(smoother="sor"), dict(cycle="k"),
               dict(coarse_solver="lu")):
        with pytest.raises(NotImplementedError):
            port.amg_setup(a, port.AMGParams(**kw), device="cpu")
    # structured coarsening is ported; without a grid it is refused
    with pytest.raises(ValueError):
        port.amg_setup(a, port.AMGParams(coarsening="structured"))
