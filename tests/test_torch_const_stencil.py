"""Port matrix-free stencil SpMV (the plain twin of
omp_amg_tpu_torch/csrc/const_stencil.cu) against the reference's
``_const_kernel`` (Pallas, interpret mode) and its XLA ``spmv_const_xla``,
on the same seeded inputs; the port's ``to_const_dia`` detection against
the reference's; and the kernel's launch geometry (``plan``,
``block_tiles``): every row written exactly once.

Tolerance: max|Δ| ≤ 1e-6·max|ref| against the Pallas kernel, whose fused
epilogues may contract into an FMA; spmv and residual are bitwise equal to
the XLA twin (the same products, summed in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omp_amg_tpu as ref
from omp_amg_tpu.amg.hierarchy import amg_setup as ref_setup
from omp_amg_tpu.ops import pallas_const
from omp_amg_tpu.ops.spmv import spmv_const_xla
from omp_amg_tpu.sparse.formats import to_const_dia as ref_to_const_dia

import omp_amg_tpu_torch as port
from omp_amg_tpu_torch.ops import const_stencil
from omp_amg_tpu_torch.sparse.formats import (
    ConstDia, Dia, const_to_dia, to_const_dia,
)

torch.set_num_threads(2)

TOL = 1e-6
GENS = {"7pt": (ref.poisson3d_7pt, port.poisson3d_7pt),
        "27pt": (ref.poisson3d_27pt, port.poisson3d_27pt)}
MODES = ["spmv", "residual", "jacobi", "zjr", "cja"]
S = float(np.float32(0.137))


def _pair(name, *shape):
    """(reference ConstDia, port ConstDia) of the same f32 operator."""
    gen_r, gen_p = GENS[name]
    a_r = gen_r(*shape, backend="numpy")
    cd_r = ref_to_const_dia(ref.Dia(data=jnp.asarray(a_r.data, jnp.float32),
                                    offsets=a_r.offsets, dims=a_r.dims))
    a_p = gen_p(*shape)
    cd_p = to_const_dia(Dia(data=a_p.data.astype(np.float32),
                            offsets=a_p.offsets, dims=a_p.dims), device="cpu")
    assert cd_r is not None and cd_p is not None
    return cd_r, cd_p


def _vectors(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(3)]


def _run_both(cd_r, cd_p, mode, x, b, p, interpret=True):
    j = {k: jnp.asarray(v) for k, v in (("x", x), ("b", b), ("p", p))}
    t = {k: torch.from_numpy(v) for k, v in (("x", x), ("b", b), ("p", p))}
    s_j = jnp.float32(S)
    kw = dict(interpret=interpret)
    if mode == "spmv":
        want = pallas_const.spmv_const(cd_r, j["x"], **kw)
        got = const_stencil.spmv(cd_p, t["x"])
    elif mode == "residual":
        want = pallas_const.residual_const(cd_r, j["x"], j["b"], **kw)
        got = const_stencil.residual(cd_p, t["x"], t["b"])
    elif mode == "jacobi":
        want = pallas_const.jacobi_const(cd_r, j["x"], j["b"], s_j, **kw)
        got = const_stencil.jacobi(cd_p, t["x"], t["b"], S)
    elif mode == "zjr":
        want = pallas_const.presmooth_residual_const(cd_r, j["b"], s_j, **kw)
        got = const_stencil.presmooth_residual(cd_p, t["b"], S)
    else:
        want = pallas_const.correct_jacobi_const(cd_r, j["b"], j["p"], s_j,
                                                 **kw)
        got = const_stencil.correct_jacobi(cd_p, t["b"], t["p"], S)
    assert got.dtype == torch.float32
    return np.asarray(want, np.float64), got.numpy().astype(np.float64)


def _close(want, got):
    assert want.shape == got.shape
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(GENS))
def test_const_modes_match_pallas_kernel(name, mode):
    # (nx, ny, nz) = (128, 16, 8): dims (8, 16, 128), as test_const_dia
    cd_r, cd_p = _pair(name, 128, 16, 8)
    x, b, p = _vectors(cd_p.n_rows, 0)
    _close(*_run_both(cd_r, cd_p, mode, x, b, p))


@pytest.mark.parametrize("name", list(GENS))
def test_spmv_and_residual_bitwise_equal_xla(name):
    cd_r, cd_p = _pair(name, 128, 16, 8)
    x, b, _ = _vectors(cd_p.n_rows, 1)
    y_ref = np.asarray(spmv_const_xla(cd_r, jnp.asarray(x)))
    y = const_stencil.spmv(cd_p, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(y, y_ref)
    r = const_stencil.residual(cd_p, torch.from_numpy(x),
                               torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(r, b - y_ref)


@pytest.mark.parametrize("mode", MODES)
def test_const_modes_where_pallas_falls_back_to_xla(mode):
    # nz = 4 < 8: the reference's kernel runs its XLA fallback algebra
    cd_r, cd_p = _pair("7pt", 32, 8, 4)
    x, b, p = _vectors(cd_p.n_rows, 2)
    _close(*_run_both(cd_r, cd_p, mode, x, b, p))


def _galerkin_level():
    hier = ref_setup(ref.poisson3d_7pt(32, backend="numpy"),
                     grid=(32, 32, 32))
    lv = hier.levels[1]
    return Dia(data=np.asarray(lv.a.data, np.float32), offsets=lv.a.offsets,
               dims=lv.a.dims)


DETECTION = {
    "7pt": lambda: port.poisson3d_7pt(128, 16, 8),
    "27pt": lambda: port.poisson3d_27pt(64, 16, 8),
    "galerkin_coarse": _galerkin_level,
    "plane_not_128": lambda: port.poisson3d_7pt(24),
    "no_interior": lambda: port.poisson3d_27pt(128, 1, 2),
    "2d": lambda: port.poisson2d_5pt(128),
}


@pytest.mark.parametrize("case", list(DETECTION))
def test_detection_matches_reference(case):
    a = DETECTION[case]()
    data32 = np.asarray(a.data, np.float32)
    got = to_const_dia(Dia(data=data32, offsets=a.offsets, dims=a.dims),
                       device="cpu")
    want = ref_to_const_dia(ref.Dia(data=data32, offsets=a.offsets,
                                    dims=a.dims))
    assert (got is None) == (want is None)
    if case in ("7pt", "27pt"):
        assert isinstance(got, ConstDia)
        assert got.taps == want.taps and got.coeffs == want.coeffs
        assert got.offsets == tuple(want.offsets)
        np.testing.assert_array_equal(const_to_dia(got).data.numpy(), data32)
    else:
        assert got is None


PLAN_DIMS = [(5, 11, 37), (1, 20, 36), (1, 1, 300), (24, 20, 256),
             (128, 128, 128), (256, 256, 256), (70000, 2, 40),
             (1, 530000, 33)]


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("dims", PLAN_DIMS)
def test_plan_covers_every_row_once(dims, sms):
    """The kernel's launch geometry (``plan`` and the block decoding the
    kernel uses, ``block_tiles``): every row of the grid is written by
    exactly one (block, thread, column, step). Up to 3 M rows every row is
    counted; above, the blocks' tiles must be distinct and each axis's
    tile ranges must partition it, which gives the same."""
    nz, ny, nx = dims
    tile_x, tile_y, zchunk, blocks = const_stencil.plan(dims, sms)
    assert (tile_x, tile_y) == (const_stencil.TILE_X, const_stencil.TILE_Y)
    assert 1 <= zchunk <= nz and blocks < 2 ** 31
    x0, y0, z0, planes = const_stencil.block_tiles(dims, zchunk,
                                                   np.arange(blocks))
    assert (planes >= 1).all()
    if dims == (128, 128, 128) and sms == 132:
        assert blocks >= 4 * sms       # about four blocks per SM or more
    if nz * ny * nx <= 3_000_000:
        steps, lines, cols = np.arange(zchunk), np.arange(tile_y), \
            np.arange(tile_x)      # column 4·tx + j of thread tx
        z = z0[:, None, None, None] + steps[None, :, None, None]
        y = y0[:, None, None, None] + lines[None, None, :, None]
        x = x0[:, None, None, None] + cols[None, None, None, :]
        live = ((steps[None, :, None, None] < planes[:, None, None, None])
                & (y < ny) & (x < nx))
        flat = ((z * ny + y) * nx + x)[live]
        np.testing.assert_array_equal(
            np.bincount(flat, minlength=nz * ny * nx), 1)
        return
    tiles = np.stack([x0, y0, z0], 1)
    assert len(np.unique(tiles, axis=0)) == blocks
    assert set(x0) == set(range(0, nx, tile_x))
    assert set(y0) == set(range(0, ny, tile_y))
    chunks = sorted(set(zip(z0.tolist(), planes.tolist())))
    assert chunks[0][0] == 0 and sum(p for _, p in chunks) == nz
    assert all(a + p == b for (a, p), (b, _) in zip(chunks, chunks[1:]))
    assert blocks == len(set(x0)) * len(set(y0)) * len(chunks)


def test_wrapper_checks_and_counts_no_cpu_launch():
    _, cd = _pair("7pt", 128, 16, 8)
    x, b, _ = (torch.from_numpy(v) for v in _vectors(cd.n_rows, 3))
    before = const_stencil.launches
    const_stencil.residual(cd, x, b)
    assert const_stencil.launches == before      # the CPU twin is no launch
    with pytest.raises(ValueError):
        const_stencil.spmv(cd, x[:-1])
    with pytest.raises(ValueError):
        const_stencil.spmv(cd, x.double())
    with pytest.raises(TypeError):
        const_stencil.jacobi(cd, x, b, torch.tensor(S))
    with pytest.raises(TypeError):
        const_stencil.spmv(Dia(data=torch.zeros(1, cd.n_rows), offsets=(0,)),
                           x)
