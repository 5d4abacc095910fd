"""Port DIA SpMV (the plain twin of omp_amg_tpu_torch/csrc/dia_spmv.cu)
against the reference's rolling-plane Pallas kernel (interpret mode) and its
XLA ``spmv_dia``, on the same seeded inputs.

Tolerance: max|Δ| ≤ 1e-6·max|ref|. At most 7 f32 terms are summed per row,
so only the summation order can differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omp_amg_tpu as ref
from omp_amg_tpu.ops.pallas_spmv import (
    jacobi_plane_dia, residual_plane_dia, spmv_plane_dia,
)
from omp_amg_tpu.ops.spmv import spmv_dia
from omp_amg_tpu.sparse.formats import to_plane_dia
from omp_amg_tpu_torch.ops import dia_spmv
from omp_amg_tpu_torch.sparse.formats import Dia, dia_to_device

torch.set_num_threads(2)

TOL = 1e-6
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def problem():
    # (nz, ny, nx) = (8, 32, 64): passes the plane contract
    # (plane % 128 == 0, plane/128 ≥ 16, nz ≥ 8), as in test_pallas_spmv
    a = ref.poisson3d_7pt(64, 32, 8, backend="numpy")
    rng = np.random.default_rng(0)
    n = a.n_rows
    x = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    s = rng.uniform(0.1, 0.2, n).astype(np.float32)
    return a, x, b, s


def _port_dia(a, tdt):
    return Dia(data=torch.from_numpy(a.data.astype(np.float32)).to(tdt),
               offsets=a.offsets, dims=a.dims)


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["spmv", "residual", "jacobi"])
def test_dia_modes_match_plane_kernel(problem, mode, dtype):
    a, x, b, s = problem
    tdt, jdt = DTYPES[dtype]
    ja = ref.Dia(data=jnp.asarray(a.data, jnp.float32), offsets=a.offsets,
                 dims=a.dims)
    pm = to_plane_dia(ja, dtype=jdt)
    assert pm is not None and pm.data4.dtype == jdt
    xj, bj, sj = jnp.asarray(x), jnp.asarray(b), jnp.asarray(s)
    pa = _port_dia(a, tdt)
    xt, bt, st = torch.from_numpy(x), torch.from_numpy(b), torch.from_numpy(s)
    if mode == "spmv":
        want = spmv_plane_dia(pm, xj, interpret=True)
        got = dia_spmv.spmv(pa, xt)
    elif mode == "residual":
        want = residual_plane_dia(pm, xj, bj, interpret=True)
        got = dia_spmv.residual(pa, xt, bt)
    else:
        want = jacobi_plane_dia(pm, xj, bj, sj, interpret=True)
        got = dia_spmv.jacobi(pa, xt, bt, st)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dia_spmv_matches_xla_spmv_dia(problem, dtype):
    a, x, _, _ = problem
    tdt, jdt = DTYPES[dtype]
    ja = ref.Dia(data=jnp.asarray(a.data, jdt), offsets=a.offsets,
                 dims=a.dims)
    want = spmv_dia(ja, jnp.asarray(x))
    _close(dia_spmv.spmv(_port_dia(a, tdt), torch.from_numpy(x)).numpy(),
           want)


def test_device_form_is_lossless_bf16(problem):
    a = problem[0]
    d = dia_to_device(a, "cpu")
    assert d.data.dtype == torch.bfloat16
    np.testing.assert_array_equal(d.data.float().numpy(), a.data)
    lossy = Dia(data=a.data * 0.1, offsets=a.offsets, dims=a.dims)
    assert dia_to_device(lossy, "cpu").data.dtype == torch.float32


def test_dia_wrapper_checks_and_counts_no_cpu_launch(problem):
    a, x, b, _ = problem
    pa = _port_dia(a, torch.float32)
    before = dia_spmv.launches
    dia_spmv.residual(pa, torch.from_numpy(x), torch.from_numpy(b))
    assert dia_spmv.launches == before      # the CPU twin is no launch
    with pytest.raises(ValueError):
        dia_spmv.spmv(pa, torch.from_numpy(x[:-1]))
    with pytest.raises(ValueError):
        dia_spmv.spmv(pa, torch.from_numpy(x).double())
    with pytest.raises(TypeError):
        dia_spmv.spmv(_port_dia(a, torch.float64), torch.from_numpy(x))
