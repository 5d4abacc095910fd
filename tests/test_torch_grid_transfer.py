"""Structured grid transfers through ``ops/grid_transfer.py``: the wrappers
run the slice-form twin (``amg/structured.py::apply_restrict``,
``apply_prolong``) on CPU tensors without a launch (``correct`` is
x + P·xc); their checks raise; a numpy mirror of the kernel's point-by-point
evaluation (out-of-grid neighbours read as 0, the axes nested z first) is
bitwise the twin; and the kernel's launch geometry (``plan``,
``block_tiles``) writes every output point exactly once.

On the card (marked ``cuda``, skipped elsewhere): the kernel against the
twin with ``torch.equal`` for restrict, prolong and prolong-add in f32 and
f64, and a structured V-cycle at 64³ against the slice form's, bit for bit,
with 2 launches per level. Run there with

    python -m pytest --noconftest tests/test_torch_grid_transfer.py -q -m cuda
"""

import numpy as np
import pytest
import torch

import omp_amg_tpu_torch as amg
from omp_amg_tpu_torch.amg.structured import (
    GridProlong, GridRestrict, apply_prolong, apply_restrict,
)
from omp_amg_tpu_torch.ops import grid_transfer

torch.set_num_threads(2)

T, F = True, False
# (fine, coarse, coarsened): all axes, one and two of three (9×17×33),
# x kept, even, odd and mixed extents, 2D and 1D
SHAPES = {
    "256^3": ((256, 256, 256), (128, 128, 128), (T, T, T)),
    "9x17x33-x": ((9, 17, 33), (9, 17, 17), (F, F, T)),
    "9x17x33-zx": ((9, 17, 33), (5, 17, 17), (T, F, T)),
    "9x17x33-zy": ((9, 17, 33), (5, 9, 33), (T, T, F)),
    "even": ((8, 10, 12), (4, 5, 6), (T, T, T)),
    "odd": ((9, 11, 13), (5, 6, 7), (T, T, T)),
    "mixed": ((10, 11, 12), (5, 6, 6), (T, T, T)),
    "2d": ((64, 48), (32, 24), (T, T)),
    "2d-odd": ((33, 31), (17, 16), (T, T)),
    "1d-odd": ((33,), (17,), (T,)),
    "1d-even": ((32,), (16,), (T,)),
}
CPU_SHAPES = [k for k in SHAPES if k != "256^3"]
DTYPES = {"f32": torch.float32, "f64": torch.float64}
KINDS = ["restrict", "prolong", "correct"]


def _ops(case):
    fine, coarse, coarsened = SHAPES[case]
    return (GridProlong(fine, coarse, coarsened),
            GridRestrict(fine, coarse, coarsened))


def _inputs(case, dtype, device="cpu", seed=0):
    """(p, r, xf, xc, x) with seeded normals."""
    p, r = _ops(case)
    rng = np.random.default_rng(seed)

    def vec(n):
        return torch.from_numpy(rng.standard_normal(n)).to(device, dtype)
    return p, r, vec(p.n_rows), vec(p.n_cols), vec(p.n_rows)


def _call(kind, p, r, xf, xc, x, module=grid_transfer):
    if kind == "restrict":
        return module.restrict(r, xf)
    if kind == "prolong":
        return module.prolong(p, xc)
    return module.correct(p, xc, x)


def _twin(kind, p, r, xf, xc, x):
    if kind == "restrict":
        return apply_restrict(r, xf)
    if kind == "prolong":
        return apply_prolong(p, xc)
    return x + apply_prolong(p, xc)


# --- the wrappers on CPU tensors ---------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", CPU_SHAPES)
def test_cpu_runs_the_twin_without_a_launch(case, kind, dtype):
    args = _inputs(case, DTYPES[dtype])
    before = grid_transfer.launches
    got = _call(kind, *args)
    assert grid_transfer.launches == before
    assert got.is_contiguous()
    assert torch.equal(got, _twin(kind, *args))


def _bad(case):
    """(callable, exception) that the wrappers must raise."""
    p, r, xf, xc, x = _inputs("odd", torch.float32)
    cases = {
        "int-dtype": (lambda: grid_transfer.restrict(r, xf.int()),
                      ValueError),
        "bf16-dtype": (lambda: grid_transfer.prolong(p, xc.bfloat16()),
                       ValueError),
        "short": (lambda: grid_transfer.restrict(r, xf[:-1]), ValueError),
        "2-d": (lambda: grid_transfer.prolong(p, xc[None]), ValueError),
        "strided": (lambda: grid_transfer.prolong(
            p, torch.zeros(2 * p.n_cols)[::2]), ValueError),
        "x-strided": (lambda: grid_transfer.correct(
            p, xc, torch.zeros(2 * p.n_rows)[::2]), ValueError),
        "x-dtype": (lambda: grid_transfer.correct(p, xc, x.double()),
                    ValueError),
        "x-shape": (lambda: grid_transfer.correct(p, xc, x[:-1]),
                    ValueError),
        "extents": (lambda: grid_transfer.restrict(
            GridRestrict((9,), (3,), (True,)), torch.zeros(9)), ValueError),
        "kept-extents": (lambda: grid_transfer.prolong(
            GridProlong((9, 4), (5, 3), (True, False)), torch.zeros(15)),
            ValueError),
        "restrict-op": (lambda: grid_transfer.restrict(p, xf), TypeError),
        "prolong-op": (lambda: grid_transfer.prolong(r, xc), TypeError),
    }
    return cases[case]


@pytest.mark.parametrize("case", [
    "int-dtype", "bf16-dtype", "short", "2-d", "strided", "x-strided",
    "x-dtype", "x-shape", "extents", "kept-extents", "restrict-op",
    "prolong-op"])
def test_checks_raise(case):
    fn, exc = _bad(case)
    before = grid_transfer.launches
    with pytest.raises(exc):
        fn()
    assert grid_transfer.launches == before


# --- the kernel's arithmetic, mirrored in numpy ------------------------------

def _mirror(kind, fine, coarse, coarsened, v, x=None):
    """The kernel's evaluation, vectorised over its output points: each
    point reads its neighbourhood with out-of-grid values as 0, then
    reduces axis 0 first, then axis 1, then axis 2, each step with the
    twin's rounding (restrict e + ½(l + r); prolong ½(l + r) on odd
    points)."""
    fine = grid_transfer.dims3(fine)
    coarse = grid_transfer.dims3(coarse)
    flags = (False,) * (3 - len(coarsened)) + tuple(coarsened)
    h = v.dtype.type(0.5)
    if kind == "restrict":
        grid = np.pad(v.reshape(fine), 1)       # fine i at i + 1
        idx = np.meshgrid(*(np.arange(n) for n in coarse), indexing="ij")
        taps = [(2 * j - 1, 2 * j, 2 * j + 1) if c else (j,)
                for j, c in zip(idx, flags)]

        def reduce(vals, c):   # vals: the axis's taps in order
            return vals[1] + h * (vals[0] + vals[2]) if c else vals[0]
        vals = [[[grid[a + 1, b + 1, c + 1] for c in taps[2]]
                 for b in taps[1]] for a in taps[0]]
        zs = [[reduce([vals[a][b][c] for a in range(len(taps[0]))], flags[0])
               for c in range(len(taps[2]))] for b in range(len(taps[1]))]
        ys = [reduce([zs[b][c] for b in range(len(taps[1]))], flags[1])
              for c in range(len(taps[2]))]
        return reduce(ys, flags[2]).reshape(-1)
    grid = np.pad(v.reshape(coarse), ((0, 1),) * 3)   # the right neighbour
    idx = np.meshgrid(*(np.arange(n) for n in fine), indexing="ij")
    base = [i // 2 if c else i for i, c in zip(idx, flags)]
    odd = [(i % 2 == 1) & c for i, c in zip(idx, flags)]
    vals = [[[grid[base[0] + a, base[1] + b, base[2] + c] for c in (0, 1)]
             for b in (0, 1)] for a in (0, 1)]

    def reduce(pair, o):
        return np.where(o, h * (pair[0] + pair[1]), pair[0])
    zs = [[reduce((vals[0][b][c], vals[1][b][c]), odd[0]) for c in (0, 1)]
          for b in (0, 1)]
    ys = [reduce((zs[0][c], zs[1][c]), odd[1]) for c in (0, 1)]
    out = reduce(ys, odd[2]).reshape(-1)
    return out if x is None else x + out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", CPU_SHAPES)
def test_pointwise_nesting_equals_twin(case, kind, dtype):
    p, r, xf, xc, x = _inputs(case, DTYPES[dtype], seed=5)
    fine, coarse, coarsened = SHAPES[case]
    v = (xf if kind == "restrict" else xc).numpy()
    got = _mirror("restrict" if kind == "restrict" else "prolong", fine,
                  coarse, coarsened, v,
                  x.numpy() if kind == "correct" else None)
    assert got.dtype == v.dtype
    np.testing.assert_array_equal(got, _twin(kind, p, r, xf, xc, x).numpy())


# --- the launch geometry -----------------------------------------------------

@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("kind", ["restrict", "prolong"])
@pytest.mark.parametrize("case", list(SHAPES))
def test_plan_covers_every_output_once(case, kind, sms):
    """``plan`` and the block decoding the kernel uses (``block_tiles``):
    every output point is written by exactly one (block, thread, column,
    step). Up to 3 M points every point is counted; above, the blocks'
    tiles must be distinct and each axis's tile ranges must partition it,
    which gives the same."""
    fine, coarse, _ = SHAPES[case]
    dims = grid_transfer.dims3(coarse if kind == "restrict" else fine)
    nz, ny, nx = dims
    pl = grid_transfer.plan(dims, sms)
    lanes, rows, zchunk, blocks = pl.lanes, pl.rows, pl.zchunk, pl.blocks
    assert 1 <= lanes <= 32 and lanes * rows <= grid_transfer.THREADS
    assert 1 <= zchunk <= nz and blocks < 2 ** 31
    x0, y0, z0, planes = grid_transfer.block_tiles(dims, pl,
                                                   np.arange(blocks))
    assert (planes >= 1).all()
    width = lanes * grid_transfer.WIDTH
    if dims == (256, 256, 256) and sms == 132:
        assert blocks >= 4 * sms       # about four blocks per SM or more
    if nz * ny * nx <= 3_000_000:
        steps, lines, cols = np.arange(zchunk), np.arange(rows), \
            np.arange(width)           # column WIDTH·tx + j of thread tx
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
    assert set(x0) == set(range(0, nx, width))
    assert set(y0) == set(range(0, ny, rows))
    assert set(z0) == set(range(0, nz, zchunk))
    assert int(planes.sum()) == nz * len(set(x0)) * len(set(y0))


# --- on the card -------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CPU runs the plain twin)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", list(SHAPES))
def test_kernel_equals_twin(case, kind, dtype):
    _need_cuda()
    args = _inputs(case, DTYPES[dtype], "cuda", seed=7)
    before = grid_transfer.launches
    got = _call(kind, *args)
    assert grid_transfer.launches == before + 1
    want = _twin(kind, *args)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_refuses_four_axes():
    _need_cuda()
    p = GridProlong((4, 4, 4, 4), (2, 2, 2, 2), (True,) * 4)
    xc = torch.zeros(p.n_cols, device="cuda")
    assert apply_prolong(p, xc).shape == (p.n_rows,)   # the twin takes it
    with pytest.raises(ValueError, match="axes"):
        grid_transfer.prolong(p, xc)


@pytest.mark.cuda
def test_vcycle_equals_slice_form(monkeypatch):
    """A structured V-cycle at 64³ on the card, through the kernel and
    through the slice form (the twin on the same CUDA tensors): bit for
    bit, with one restriction and one prolongation launch per level."""
    _need_cuda()
    n = 64
    a = amg.poisson3d_7pt(n)
    hier = amg.amg_setup(a, amg.AMGParams(), grid=(n,) * 3, device="cuda")
    levels = sum(isinstance(lv.p, GridProlong) for lv in hier.levels)
    assert levels == len(hier.levels) >= 4
    b = amg.default_rhs(a, seed=0).to("cuda", torch.float32)
    before = grid_transfer.launches
    got = amg.vcycle(hier, b)
    got2 = amg.vcycle(hier, got)
    assert grid_transfer.launches == before + 2 * 2 * levels

    def slice_form(op, v, x=None):
        if isinstance(op, GridRestrict):
            return apply_restrict(op, v)
        return apply_prolong(op, v) if x is None else x + apply_prolong(op, v)
    monkeypatch.setattr(grid_transfer, "_launch", slice_form)
    want = amg.vcycle(hier, b)
    want2 = amg.vcycle(hier, want)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got2, want2)
