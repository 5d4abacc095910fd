"""Port DIA SpMV (the plain twin of omp_amg_tpu_torch/csrc/dia_spmv.cu)
against the reference's rolling-plane Pallas kernel (interpret mode) and its
XLA ``spmv_dia``, on the same seeded inputs.

Tolerance: max|Δ| ≤ 1e-6·max|ref|. At most 7 f32 terms are summed per row,
so only the summation order can differ.

Also the host rule that sends a product down the kernel's vector path
(``vector_path``) or its scalar path, on the main paths' shapes and on
shapes that must take the scalar path.
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
    before = dia_spmv.launches, dia_spmv.scalar_launches
    dia_spmv.residual(pa, torch.from_numpy(x), torch.from_numpy(b))
    # the CPU twin is no launch, on either path
    assert (dia_spmv.launches, dia_spmv.scalar_launches) == before
    with pytest.raises(ValueError):
        dia_spmv.spmv(pa, torch.from_numpy(x[:-1]))
    with pytest.raises(ValueError):
        dia_spmv.spmv(pa, torch.from_numpy(x).double())
    with pytest.raises(TypeError):
        dia_spmv.spmv(_port_dia(a, torch.float64), torch.from_numpy(x))


SMS = 132    # an H100 SXM


def _operands(n, ndiag, dtype, x_len=None):
    return (Dia(data=torch.empty((ndiag, n), dtype=dtype),
                offsets=tuple(range(ndiag))),
            torch.empty(n if x_len is None else x_len))


@pytest.mark.parametrize("n,ndiag,dtype,x_base,x_len,vector", [
    (128 ** 3, 7, torch.bfloat16, 0, None, True),      # PMIS 128³ L0
    (128 ** 3, 7, torch.float32, 0, None, True),       # the same in f32
    (1024 ** 2, 5, torch.bfloat16, 0, None, True),     # 2D 1024² L0
    (512 ** 2, 9, torch.bfloat16, 0, None, False),     # its 512² level
    (64 ** 3, 27, torch.bfloat16, 0, None, False),     # structured 64³
    (32 ** 3, 27, torch.float32, 0, None, False),      # structured 32³
    (8 ** 3, 27, torch.float32, 0, None, False),       # structured 8³
    # a 128³ L0 shard of 4 in its exchanged window: too few threads of 8
    # rows to fill the card
    (128 ** 3 // 4, 7, torch.bfloat16, 16384, 557056, False),
])
def test_vector_path_on_main_path_shapes(n, ndiag, dtype, x_base, x_len,
                                         vector):
    a, x = _operands(n, ndiag, dtype, x_len)
    b = torch.empty(n)
    assert dia_spmv.vector_path(a, x, x_base, (b,), SMS) is vector
    # every one of them meets the vector path's operand conditions: with
    # the thread count out of the rule (no SMs to fill), all take it
    assert dia_spmv.vector_path(a, x, x_base, (b,), 0)


@pytest.mark.parametrize("case", ["n=13823", "bf16 n%8=4", "odd x_base",
                                  "x misaligned", "b misaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vector_path_needs_divisible_aligned_operands(case, dtype):
    n, x_base = 13824, 0          # 24³: the vector path on one SM
    buf = torch.empty(2 * n + 8)
    x, b = buf[:n], torch.empty(n)
    if case == "n=13823":
        n = 13823
        x, b = buf[:n], b[:n]
    elif case == "bf16 n%8=4":
        n = 13820
        x, b = buf[:n], b[:n]
    elif case == "odd x_base":
        x_base, x = 1, buf[:n + 1]
    elif case == "x misaligned":
        x = buf[1:n + 1]
    else:
        b = torch.empty(n + 1)[1:]
    a = Dia(data=torch.empty((7, n), dtype=dtype), offsets=tuple(range(7)))
    want = case == "bf16 n%8=4" and dtype == torch.float32
    assert dia_spmv.vector_path(a, x, x_base, (b,), 1) is want
    # the aligned 24³ operands themselves take the vector path
    a = Dia(data=torch.empty((7, 13824), dtype=dtype),
            offsets=tuple(range(7)))
    assert dia_spmv.vector_path(a, buf[:13824], 0, (torch.empty(13824),), 1)
