"""The port's smoothers against the reference's, on the CPU:

- ``chebyshev`` (from a given x and from zero, ``x_is_zero``) on the three
  level forms: a banded ``Dia`` (7-point 12³), a ``Csr`` (the reference's
  ``Ell`` of the 27-point 8³ operator) and a ``ConstDia`` (27-point 16³),
  each with the same ``dinv``, ``lmax`` and vectors: max|Δ| ≤
  1e-5·max|ref|;
- ``estimate_lmax`` (power iteration from the hash01 start) on the ``Dia``
  and ``Ell``/``Csr`` forms, rtol 1e-5, and the same value from the port's
  three forms of one operator;
- the l1 diagonals: the PMIS setup's (1/Σ|a_ij| by host CSR rows) and the
  structured setup's (1/Σ|data| over the planes) equal the reference's, and
  the structured ``ConstDia`` level keeps its varying l1 scale per row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omp_amg_tpu as ref
from omp_amg_tpu.amg.hierarchy import amg_setup as ref_setup
from omp_amg_tpu.amg.params import AMGParams as RefParams
from omp_amg_tpu.amg.smoothers import chebyshev as ref_chebyshev
from omp_amg_tpu.amg.smoothers import estimate_lmax as ref_estimate_lmax
from omp_amg_tpu.sparse.formats import (
    dia_to_scipy as ref_dia_to_scipy, ell_from_scipy,
    to_const_dia as ref_to_const_dia,
)

import omp_amg_tpu_torch as port
from omp_amg_tpu_torch.sparse.formats import (
    ConstDia, csr_from_scipy, dia_to_device, to_const_dia,
)

torch.set_num_threads(2)

FORMS = {
    # form: (generator, edge)
    "dia": ("poisson3d_7pt", 12),
    "csr": ("poisson3d_27pt", 8),
    "const": ("poisson3d_27pt", 16),
}


def _operators(form):
    """The same operator in the reference's and the port's form of
    ``form``, and its f32 inverse diagonal (varied by ±5 %, so that a
    constant-diagonal shortcut would show)."""
    gen, n = FORMS[form]
    a_np = getattr(port, gen)(n)
    host = port.Dia(data=a_np.data.astype(np.float32), offsets=a_np.offsets,
                    dims=a_np.dims)
    a_j = ref.Dia(data=jnp.asarray(host.data), offsets=host.offsets,
                  dims=host.dims)
    if form == "dia":
        a_t = dia_to_device(host, "cpu")
    elif form == "csr":
        sp = port.dia_to_scipy(host)
        a_j = ell_from_scipy(ref_dia_to_scipy(a_j))
        a_t = csr_from_scipy(sp, device="cpu")
    else:
        a_j = ref_to_const_dia(a_j)
        a_t = to_const_dia(host, "cpu")
        assert isinstance(a_t, ConstDia) and a_j is not None
    diag = host.data[host.offsets.index(0)]
    rng = np.random.default_rng(5)
    dinv = (1.0 / diag * rng.uniform(0.95, 1.05, diag.size)).astype(
        np.float32)
    return a_j, a_t, dinv


@pytest.mark.parametrize("x_is_zero", [False, True])
@pytest.mark.parametrize("form", list(FORMS))
def test_chebyshev_matches_reference(form, x_is_zero):
    a_j, a_t, dinv = _operators(form)
    n = dinv.size
    rng = np.random.default_rng(11)
    x, b = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    lmax = np.float32(1.93)
    prm = RefParams(smoother="chebyshev")

    def ref_fn(a, d, x, b, lm):
        return ref_chebyshev(a, d, None if x_is_zero else x, b, lm,
                             prm.cheby_degree, prm.cheby_ratio,
                             x_is_zero=x_is_zero)
    want = np.asarray(jax.jit(ref_fn)(a_j, jnp.asarray(dinv), jnp.asarray(x),
                                      jnp.asarray(b), jnp.asarray(lmax)),
                      np.float64)
    got = port.chebyshev(a_t, torch.from_numpy(dinv),
                         None if x_is_zero else torch.from_numpy(x),
                         torch.from_numpy(b), float(lmax), prm.cheby_degree,
                         prm.cheby_ratio, x_is_zero=x_is_zero)
    got = got.numpy().astype(np.float64)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (err, np.abs(want).max())


def test_chebyshev_scalar_dinv_on_const_level():
    """A ``ConstDia`` level with a constant diagonal passes D⁻¹ as one
    float: the same result as the per-row tensor."""
    a = to_const_dia(port.Dia(
        data=port.poisson3d_7pt(16).data.astype(np.float32),
        offsets=port.poisson3d_7pt(16).offsets, dims=(16,) * 3), "cpu")
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(
        a.n_rows).astype(np.float32))
    d = float(np.float32(1.0 / 6.0))
    one = port.chebyshev(a, d, None, b, 1.9, 3, 30.0, x_is_zero=True)
    full = port.chebyshev(a, torch.full((a.n_rows,), d), None, b, 1.9, 3,
                          30.0, x_is_zero=True)
    assert torch.equal(one, full)


@pytest.mark.parametrize("form", ["dia", "csr"])
def test_estimate_lmax_matches_reference(form):
    a_j, a_t, dinv = _operators(form)
    want = float(jax.jit(ref_estimate_lmax)(a_j, jnp.asarray(dinv)))
    got = port.estimate_lmax(a_t, torch.from_numpy(dinv))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_estimate_lmax_same_on_every_form():
    a = port.poisson3d_27pt(16)
    host = port.Dia(data=a.data.astype(np.float32), offsets=a.offsets,
                    dims=a.dims)
    dinv = torch.full((a.n_rows,), float(np.float32(1.0 / 26.0)))
    vals = [port.estimate_lmax(op, dinv) for op in (
        dia_to_device(host, "cpu"),
        csr_from_scipy(port.dia_to_scipy(host), device="cpu"),
        to_const_dia(host, "cpu"))]
    assert max(vals) - min(vals) <= 1e-5 * max(vals), vals
    assert 1.0 < vals[0] < 2.0


def test_pmis_l1_diagonal_matches_reference():
    a = port.poisson3d_7pt(12)
    prm = dict(coarsening="pmis", smoother="l1jacobi")
    hier_j, ops_j = ref_setup(ref.poisson3d_7pt(12, backend="numpy"),
                              RefParams(**prm), keep_host=True)
    hier_t, host = port.amg_setup(a, port.AMGParams(**prm), device="cpu",
                                  keep_host=True)
    assert len(hier_t.levels) == len(hier_j.levels)
    for l, (lt, lj) in enumerate(zip(hier_t.levels, hier_j.levels)):
        want = 1.0 / np.asarray(abs(host.ops[l]).sum(axis=1)).ravel()
        np.testing.assert_array_equal(lt.dinv, want.astype(np.float32))
        np.testing.assert_array_equal(lt.dinv, np.asarray(lj.dinv))
        np.testing.assert_allclose(lt.lmax, float(np.asarray(lj.lmax)),
                                   rtol=1e-12)
        np.testing.assert_array_equal(lt.dinv_dev.numpy(), lt.dinv)
    # the fine rows of the 7-point operator: 6 at the centre of the grid
    assert hier_t.levels[0].dinv.min() == np.float32(1.0 / 12.0)


@pytest.mark.parametrize("gen,dims", [("poisson3d_7pt", (16, 16, 16)),
                                      ("poisson2d_5pt", (32, 32))])
def test_structured_l1_diagonal_matches_reference(gen, dims):
    prm = dict(smoother="l1jacobi")
    hier_j = ref_setup(getattr(ref, gen)(dims[0], backend="numpy"),
                       RefParams(**prm), grid=dims)
    hier_t, host = port.amg_setup(getattr(port, gen)(dims[0]),
                                  port.AMGParams(**prm), grid=dims,
                                  device="cpu", keep_host=True)
    assert len(hier_t.levels) == len(hier_j.levels)
    for l, (lt, lj) in enumerate(zip(hier_t.levels, hier_j.levels)):
        want = 1.0 / np.asarray(abs(host.ops[l]).sum(axis=1)).ravel()
        np.testing.assert_allclose(lt.dinv, want, rtol=1e-7)
        np.testing.assert_array_equal(lt.dinv, np.asarray(lj.dinv))
        np.testing.assert_allclose(lt.lmax, float(np.asarray(lj.lmax)),
                                   rtol=1e-6)
        # the l1 scale varies at the boundary: per row even on a ConstDia
        assert isinstance(lt.s, torch.Tensor)
        assert isinstance(lt.dinv_dev, torch.Tensor)
    if len(dims) == 3:
        assert isinstance(hier_t.levels[0].a, ConstDia)
        # with plain Jacobi the ConstDia level keeps its scalar operands
        lv = port.amg_setup(port.poisson3d_7pt(16), port.AMGParams(),
                            grid=dims, device="cpu").levels[0]
        assert isinstance(lv.s, float) and isinstance(lv.dinv_dev, float)
