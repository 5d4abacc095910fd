"""The port's CUDA kernels on the card: each kernel × mode × value type
against its plain twin on the same CUDA tensors (``dia_spmv`` also over an
x window and on both its vector and scalar paths, ``csr_spmv`` at every
lane width on rows of 0 to 200 nonzeros, ``const_stencil`` on ragged,
one-plane, one-line, interior-block and unaligned grids at any z-chunk,
``panel_spmm`` on both of its instances, ``remote_halo``'s windows
exactly on both of its paths, ``tile_csr`` bitwise the CSR kernel in every
mode × value type × lane width of its rule, also through a certified 64³
PMIS solve), and the GPU solves' iteration counts
(PMIS, PMIS with the probed Galerkin values, structured, structured on a
4-shard mesh and PMIS on a 4-shard mesh, whose shard windows the CSR kernel
also reads against its twin; and with the Chebyshev and l1-Jacobi
smoothers, the W and F cycles, the ``inv`` coarse solve, the pipelined PCG
and the device certified loop) against the port's CPU solves; and the
device-flavor setups (PMIS and structured) against the same setups on the
CPU, ``hash01`` and the device ``to_const_dia``. Needs an NVIDIA GPU and nvcc;
skipped elsewhere (the CPU runs only the twins). Run on the card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

import omp_amg_tpu_torch as amg
from omp_amg_tpu_torch.ops import (
    const_stencil, csr_spmv, dia_spmv, extract_lanes, panel_spmm, probe_rap,
    remote_halo,
)
from omp_amg_tpu_torch.sparse.formats import (
    ConstDia, Csr, Dia, csr_from_scipy, to_const_dia,
)

pytestmark = pytest.mark.cuda

PARAMS = amg.AMGParams(coarsening="pmis")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CPU runs the plain twins)")


@pytest.fixture(scope="module")
def hier():
    _need_cuda()
    return amg.amg_setup(amg.poisson3d_7pt(24), PARAMS, device="cuda")


def _vec(rng, n):
    return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()


def _check(got, want, bound):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= bound * float(want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["spmv", "residual", "jacobi"])
def test_dia_kernel_matches_twin(hier, mode, dtype):
    lv = hier.levels[0]
    a = Dia(data=lv.a.data.to(dtype).contiguous(), offsets=lv.a.offsets)
    rng = np.random.default_rng(0)
    x, b = _vec(rng, a.n_rows), _vec(rng, a.n_rows)
    before = dia_spmv.launches
    got = {"spmv": lambda: dia_spmv.spmv(a, x),
           "residual": lambda: dia_spmv.residual(a, x, b),
           "jacobi": lambda: dia_spmv.jacobi(a, x, b, lv.s)}[mode]()
    assert dia_spmv.launches == before + 1
    # explicit rounding in ascending tap order: bitwise the twin
    _check(got, dia_spmv.dia_spmv_plain(a, x, mode, b, lv.s), 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["spmv", "residual", "correct", "jacobi"])
def test_csr_kernel_matches_twin(hier, mode, dtype):
    rng = np.random.default_rng(1)
    for lv in hier.levels:
        ops = [lv.a] if mode == "jacobi" else [lv.p, lv.r]
        for op in ops:
            if not isinstance(op, Csr):
                continue
            a = Csr(op.indptr, op.indices, op.vals.to(dtype).contiguous(),
                    op.n_cols)
            x, v = _vec(rng, a.n_cols), _vec(rng, a.n_rows)
            before = csr_spmv.launches
            got = {"spmv": lambda: csr_spmv.spmv(a, x),
                   "residual": lambda: csr_spmv.residual(a, x, v),
                   "correct": lambda: csr_spmv.correct(a, x, v),
                   "jacobi": lambda: csr_spmv.jacobi(a, x, v, lv.s)}[mode]()
            assert csr_spmv.launches == before + 1
            want = csr_spmv.csr_spmv_plain(a, x, mode, v=v, b=v, s=lv.s)
            _check(got, want, 1e-5)


CONST_MODES = ["spmv", "residual", "jacobi", "zjr", "cja"]


def _const_op(points, dims):
    """A ``ConstDia`` on the card: the 7-point star or the 27-point box (the
    kernel's two tap tables, taps in ascending offset order), or a 13-point
    star reaching two lines and columns (its general instance); distinct
    exact coefficients, so that a misplaced tap shows."""
    if points == "poisson27":     # the detected operator of a generator
        a = amg.poisson3d_27pt(*dims[::-1])
        return to_const_dia(Dia(data=a.data.astype(np.float32),
                                offsets=a.offsets, dims=a.dims),
                            device="cuda")
    nz, ny, nx = dims
    box = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
           for dx in (-1, 0, 1)]
    taps = box if points == 27 else [t for t in box
                                     if sum(map(abs, t)) <= 1]
    if points == 13:
        taps = sorted(taps + [(0, -2, 0), (0, 2, 0), (0, 0, -2), (0, 0, 2),
                              (0, -1, 1), (0, 1, -1)],
                      key=lambda t: (t[0] * ny + t[1]) * nx + t[2])
    return ConstDia(
        coeffs=tuple((-1.0) ** k * 0.125 * (k + 1) for k in range(len(taps))),
        offsets=tuple((dz * ny + dy) * nx + dx for dz, dy, dx in taps),
        taps=tuple(taps), dims=dims,
        device=torch.empty(0, device="cuda").device)


# (stencil, dims (nz, ny, nx), vector offset): nx, ny, nz off the tile and
# chunk sizes; one plane; one line; grids with guard-free interior blocks
# (16-byte and, with vectors one float off a 16-byte boundary, 4-byte
# staging); the general instance
CONST_CASES = {
    "poisson27-16x32x64": ("poisson27", (16, 32, 64), 0),
    "7pt-5x11x37": (7, (5, 11, 37), 0),
    "27pt-5x11x37": (27, (5, 11, 37), 0),
    "7pt-plane": (7, (1, 20, 36), 0),
    "27pt-plane": (27, (1, 20, 36), 0),
    "7pt-line": (7, (1, 1, 300), 0),
    "27pt-line": (27, (1, 1, 300), 0),
    "7pt-interior": (7, (24, 20, 256), 0),
    "27pt-interior": (27, (24, 20, 256), 0),
    "7pt-unaligned": (7, (6, 9, 132), 1),
    "13pt-general": (13, (6, 9, 21), 0),
}


def _const_inputs(case, seed=2):
    points, dims, shift = CONST_CASES[case]
    a = _const_op(points, dims)
    rng = np.random.default_rng(seed)
    x, b, p = (_vec(rng, a.n_rows + shift)[shift:] for _ in range(3))
    return a, x, b, p, float(np.float32(0.137))


def _const_twin(a, mode, x, b, p, s):
    """The twin of one mode (x carries b in zjr and cja)."""
    return const_stencil.const_stencil_plain(a, x, mode, b=b, p=p, s=s)


@pytest.mark.parametrize("mode", CONST_MODES)
@pytest.mark.parametrize("case", list(CONST_CASES))
def test_const_stencil_kernel_matches_twin(case, mode):
    _need_cuda()
    a, x, b, p, s = _const_inputs(case)
    before = const_stencil.launches
    got = {"spmv": lambda: const_stencil.spmv(a, x),
           "residual": lambda: const_stencil.residual(a, x, b),
           "jacobi": lambda: const_stencil.jacobi(a, x, b, s),
           "zjr": lambda: const_stencil.presmooth_residual(a, x, s),
           "cja": lambda: const_stencil.correct_jacobi(a, x, p, s)
           }[mode]()
    assert const_stencil.launches == before + 1
    # explicit rounding in ascending tap order: bitwise the twin
    _check(got, _const_twin(a, mode, x, b, p, s), 0.0)


@pytest.mark.parametrize("zchunk", [1, 2, 3, 5, 64])
@pytest.mark.parametrize("case", ["7pt-5x11x37", "27pt-interior",
                                  "7pt-unaligned", "13pt-general"])
def test_const_stencil_kernel_any_zchunk_matches_twin(case, zchunk):
    """Every mode through the C entry point at a forced z-chunk length (the
    wrapper's plan gives these small grids one plane per block): the plane
    ring turns over many steps and ends on a ragged chunk."""
    _need_cuda()
    from omp_amg_tpu_torch._build import cuda_kernels

    a, x, b, p, s = _const_inputs(case)
    taps, coeffs = a.operand
    for mode in CONST_MODES:
        out = torch.empty(a.n_rows, device="cuda")
        rc = cuda_kernels().const_stencil_launch(
            CONST_MODES.index(mode), *a.dims, zchunk, len(coeffs),
            taps.ctypes.data, coeffs.ctypes.data, s, x.data_ptr(),
            b.data_ptr(), p.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        _check(out, _const_twin(a, mode, x, b, p, s), 0.0)


@pytest.mark.parametrize("mode", CONST_MODES)
@pytest.mark.parametrize("points", [7, 27])
@pytest.mark.parametrize("dims", [(70000, 2, 40), (1, 530000, 33)])
def test_const_stencil_kernel_chunks_large_grids(dims, points, mode):
    """More than 65535 planes, or more than 65535 tiles of lines: the 1-D
    launch grid carries them in one launch."""
    _need_cuda()
    a = _const_op(points, dims)
    rng = np.random.default_rng(3)
    x, b, p = (_vec(rng, a.n_rows) for _ in range(3))
    s = float(np.float32(0.137))
    got = {"spmv": lambda: const_stencil.spmv(a, x),
           "residual": lambda: const_stencil.residual(a, x, b),
           "jacobi": lambda: const_stencil.jacobi(a, x, b, s),
           "zjr": lambda: const_stencil.presmooth_residual(a, x, s),
           "cja": lambda: const_stencil.correct_jacobi(a, x, p, s)
           }[mode]()
    _check(got, _const_twin(a, mode, x, b, p, s), 0.0)


@pytest.mark.parametrize("mode", ["spmv", "residual", "jacobi"])
def test_dia_kernel_window_matches_twin(hier, mode):
    """Rows [n/4, n/2) of level 0 read from a window of x at x_base."""
    lv = hier.levels[0]
    n = lv.a.n_rows
    r0, r1, base = n // 4, n // 2, 3000
    a = Dia(data=lv.a.data[:, r0:r1].contiguous(), offsets=lv.a.offsets)
    rng = np.random.default_rng(7)
    x = _vec(rng, (r1 - r0) + 2 * base)
    b, s = _vec(rng, r1 - r0), lv.s[r0:r1].contiguous()
    before = dia_spmv.launches
    got = {"spmv": lambda: dia_spmv.spmv(a, x, x_base=base),
           "residual": lambda: dia_spmv.residual(a, x, b, x_base=base),
           "jacobi": lambda: dia_spmv.jacobi(a, x, b, s, x_base=base)}[mode]()
    assert dia_spmv.launches == before + 1
    _check(got, dia_spmv.dia_spmv_plain(a, x, mode, b, s, x_base=base), 0.0)


@pytest.mark.parametrize("source", ["fresh", "chunks", "offset"])
@pytest.mark.parametrize("d,n,nl,nr", [(4, 131072, 16384, 16384),
                                       (3, 1000, 100, 0), (8, 4096, 0, 512),
                                       (64, 640, 64, 64), (5, 1001, 7, 3)])
def test_remote_halo_exact(d, n, nl, nr, source):
    """The window kernel bitwise its twin on fresh shards, on chunk views of
    one vector (as ``ShardMesh.shard`` gives them) and on chunk views one
    float off a 16-byte boundary; the wrapper's path, and the scalar path
    forced through the C entry point."""
    _need_cuda()
    from omp_amg_tpu_torch._build import cuda_kernels

    rng = np.random.default_rng(8)
    if source == "fresh":
        srcs = [_vec(rng, n) for _ in range(d)]
    else:
        flat = _vec(rng, d * n + 1)
        srcs = list((flat[:-1] if source == "chunks" else flat[1:]).chunk(d))
    vec = remote_halo.vector_path(srcs, n, nl, nr)
    assert vec == (n % 4 == 0 and source != "offset")
    before = (remote_halo.launches, remote_halo.scalar_launches)
    got = remote_halo.remote_halo_window(srcs, nl, nr)
    assert (remote_halo.launches, remote_halo.scalar_launches) == (
        before[0] + 1, before[1] + (not vec))
    want = remote_halo.remote_halo_window_plain(srcs, nl, nr)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    table = remote_halo._Table(*(t.data_ptr() for t in srcs))
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(want)
    lib = cuda_kernels()
    assert lib.remote_halo_window_launch(d, n, nl, nr, out.shape[1], 0, table,
                                         None, None, out.data_ptr(),
                                         stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    if not vec:    # the vector path refuses what it cannot take
        assert lib.remote_halo_window_launch(
            d, n, nl, nr, out.shape[1], 1, table, None, None, out.data_ptr(),
            stream) != 0
    with pytest.raises(ValueError):
        remote_halo.remote_halo_window(srcs + [srcs[0]] * (65 - d), 1, 1)


def test_sharded_solve_matches_cpu_iterations():
    _need_cuda()
    a = amg.poisson3d_7pt(24)
    b = amg.default_rhs(a, seed=0)
    infos = []
    for device in ("cuda", "cpu"):
        solver = amg.AMGSolver(a, amg.AMGParams(), grid=(24, 24, 24),
                               mesh=amg.ShardMesh(4, device), device=device,
                               transport="remote")
        assert solver.stats()["sharded"][0]
        solver.solve(b, tol=1e-8)
        infos.append(solver.last_info)
    assert infos[0]["inner_iters"] == infos[1]["inner_iters"]
    assert infos[0]["outer_iters"] == infos[1]["outer_iters"]
    assert infos[0]["rel_residual"] <= 1e-8


def _random_csr(rng, n_rows, n_cols, per_row):
    """Random CSR with every fifth row empty and some stored zeros."""
    import scipy.sparse as sp

    rows = np.repeat(np.arange(n_rows), per_row)
    rows = rows[rows % 5 != 0]
    vals = rng.standard_normal(len(rows))
    vals[::7] = 0.0
    m = sp.csr_matrix((vals, (rows, rng.integers(0, n_cols, len(rows)))),
                      shape=(n_rows, n_cols))
    m.sum_duplicates()
    return m


def _ragged_csr(rng, n_rows, n_cols, longest):
    """CSR rows of 0 to ``longest`` nonzeros (every seventh row empty), on
    the card."""
    lengths = rng.integers(0, longest + 1, n_rows)
    lengths[::7] = 0
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(lengths, out=indptr[1:])
    return Csr(indptr=torch.from_numpy(indptr).cuda(),
               indices=torch.from_numpy(rng.integers(0, n_cols, indptr[-1])
                                        .astype(np.int32)).cuda(),
               vals=torch.from_numpy(rng.standard_normal(indptr[-1])
                                     .astype(np.float32)).cuda(),
               n_cols=n_cols)


@pytest.mark.parametrize("c", [1, 16, 32, 45, 64, 96, 128])
def test_panel_spmm_matches_twin_on_random_operators(c):
    """Empty rows, rows longer than one 32-pair index batch and rows of
    every length modulo the unroll (0 to 200 nonzeros)."""
    _need_cuda()
    rng = np.random.default_rng(4)
    ops = [csr_from_scipy(_random_csr(rng, n_rows, n_cols, per_row),
                          device="cuda")
           for n_rows, n_cols, per_row in ((1000, 700, 9), (300, 5000, 60))]
    ops.append(_ragged_csr(rng, 2000, 3000, 200))
    for a in ops:
        x = torch.from_numpy(rng.standard_normal((a.n_cols, c))
                             .astype(np.float32)).cuda()
        before = panel_spmm.launches
        got = panel_spmm.spmm_panel(a, x)
        assert panel_spmm.launches == before + 1
        # explicit rounding in CSR order: bitwise the twin
        _check(got, panel_spmm.spmm_panel_plain(a, x), 0.0)


@pytest.mark.parametrize("c", [32, 64, 96, 128])
def test_panel_spmm_every_instance_matches_twin(c):
    """The vector instance (q = C / 32) and the warp-per-row instance
    (q = 0) through the C entry point: bitwise the twin."""
    _need_cuda()
    from omp_amg_tpu_torch._build import cuda_kernels

    rng = np.random.default_rng(5)
    a = _ragged_csr(rng, 2000, 3000, 200)
    x = torch.from_numpy(rng.standard_normal((a.n_cols, c))
                         .astype(np.float32)).cuda()
    want = panel_spmm.spmm_panel_plain(a, x)
    for q in (panel_spmm.lane_plan(c)[0], 0):
        out = torch.empty((a.n_rows, c), device="cuda")
        rc = cuda_kernels().panel_spmm_launch(
            a.n_rows, c, q, a.indptr.data_ptr(), a.indices.data_ptr(),
            a.vals.data_ptr(), x.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        _check(out, want, 0.0)


@pytest.fixture(scope="module")
def probes():
    _need_cuda()
    params = amg.AMGParams(coarsening="pmis", rap="probe")
    _, host = amg.amg_setup(amg.poisson3d_7pt(24), params, device="cuda",
                            keep_host=True)
    return [probe_rap.build_rap_probe(host.ops[l], host.p[l],
                                      device="cuda")[0]
            for l in range(len(host.p))]


def test_probe_kernels_match_twins_on_24cubed_levels(probes):
    assert probes
    for probe in probes:
        parts = []
        for c0, width in probe.groups:
            pv = probe_rap.panel_pv(probe, c0, width)
            u = panel_spmm.spmm_panel(probe.a, pv)
            _check(u, panel_spmm.spmm_panel_plain(probe.a, pv), 0.0)
            w = panel_spmm.spmm_panel(probe.r, u)
            _check(w, panel_spmm.spmm_panel_plain(probe.r, u), 0.0)
            parts.append(w)
        w = torch.cat(parts, dim=1)
        before = extract_lanes.launches
        got = extract_lanes.extract_lanes(w, probe.ac_cidx)
        assert extract_lanes.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, extract_lanes.extract_lanes_plain(
            w, probe.ac_cidx))


def test_extract_lanes_exact_any_width():
    _need_cuda()
    rng = np.random.default_rng(6)
    for rows, width, s in ((256, 128, 256), (1000, 200, 37), (5, 1, 3)):
        w = torch.from_numpy(rng.standard_normal((rows, width))
                             .astype(np.float32)).cuda()
        idx = torch.from_numpy(rng.integers(0, width, (rows, s))
                               .astype(np.int32)).cuda()
        got = extract_lanes.extract_lanes(w, idx)
        torch.cuda.synchronize()
        assert torch.equal(got, torch.gather(w, 1, idx.long()))


def test_entry_points_default_to_the_card():
    _need_cuda()
    a = amg.poisson3d_7pt(8)
    solver = amg.AMGSolver(a, PARAMS)
    assert solver.device.type == "cuda"
    assert solver.hierarchy.device.type == "cuda"
    assert amg.amg_setup(a, PARAMS).device.type == "cuda"


@pytest.mark.parametrize("n,params,grid", [
    (24, PARAMS, None),
    (24, amg.AMGParams(coarsening="pmis", rap="probe"), None),
    (32, amg.AMGParams(), (32, 32, 32)),
])
def test_gpu_solve_matches_cpu_iterations(n, params, grid):
    _need_cuda()
    a = amg.poisson3d_7pt(n)
    b = amg.default_rhs(a, seed=0)
    infos = []
    for device in ("cuda", "cpu"):
        solver = amg.AMGSolver(a, params, device=device, grid=grid)
        solver.solve(b, tol=1e-8)
        infos.append(solver.last_info)
    assert infos[0]["inner_iters"] == infos[1]["inner_iters"]
    assert infos[0]["outer_iters"] == infos[1]["outer_iters"]
    assert infos[0]["rel_residual"] <= 1e-8


def _csr_launch(a, x, mode, vec, v=None, b=None, s=None, x_base=0):
    """``csr_spmv``'s C entry point at a forced lane width (the wrapper
    always passes ``a.vec``)."""
    from omp_amg_tpu_torch._build import cuda_kernels

    out = torch.empty(a.n_rows, device="cuda")
    vecs = (None if t is None else t.data_ptr() for t in (v, b, s))
    rc = cuda_kernels().csr_spmv_launch(
        {"spmv": 0, "residual": 1, "correct": 2, "jacobi": 3}[mode],
        int(a.vals.dtype == torch.bfloat16), vec, a.n_rows, x_base,
        a.indptr.data_ptr(), a.indices.data_ptr(), a.vals.data_ptr(),
        x.data_ptr(), *vecs, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return out


@pytest.fixture(scope="module")
def ragged():
    """A square CSR operator whose rows hold 0 to 200 nonzeros, every
    seventh row empty, and its vectors."""
    _need_cuda()
    rng = np.random.default_rng(9)
    n = 3000
    lengths = rng.integers(0, 201, n)
    lengths[::7] = 0
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=indptr[1:])
    a = Csr(indptr=torch.from_numpy(indptr).cuda(),
            indices=torch.from_numpy(rng.integers(0, n, indptr[-1])
                                     .astype(np.int32)).cuda(),
            vals=torch.from_numpy(rng.standard_normal(indptr[-1])
                                  .astype(np.float32)).cuda(), n_cols=n)
    x, v, b = (_vec(rng, n) for _ in range(3))
    s = torch.from_numpy(rng.uniform(0.1, 0.2, n).astype(np.float32)).cuda()
    return a, x, v, b, s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["spmv", "residual", "correct", "jacobi"])
@pytest.mark.parametrize("vec", [1, 2, 4, 8, 16, 32])
def test_csr_kernel_every_width_matches_twin(ragged, vec, mode, dtype):
    a, x, v, b, s = ragged
    a = Csr(a.indptr, a.indices, a.vals.to(dtype), a.n_cols)
    kw = {"spmv": {}, "residual": {"b": b}, "correct": {"v": v},
          "jacobi": {"b": b, "s": s}}[mode]
    got = _csr_launch(a, x, mode, vec, **kw)
    want = csr_spmv.csr_spmv_plain(a, x, mode, **kw)
    _check(got, want, 1e-5)
    # empty rows give exactly the epilogue of a zero sum
    empty = (a.indptr[1:] == a.indptr[:-1]).nonzero()[:, 0]
    assert torch.equal(got[empty], want[empty])
    assert torch.equal(_csr_launch(a, x, mode, vec, **kw), got)  # same bits


@pytest.mark.parametrize("vec", [1, 4, 32])
@pytest.mark.parametrize("mode", ["spmv", "residual", "correct", "jacobi"])
def test_csr_kernel_window_matches_twin(ragged, mode, vec):
    """Rows whose columns address a window longer than the rows (a shard's
    [left halo | own rows | right halo]); jacobi reads row i's own x at
    x[x_base + i]. Bitwise the twin's epilogue on the same row sums."""
    a, _, v, b, s = ragged
    rng = np.random.default_rng(11)
    h = 517
    win = Csr(a.indptr, (a.indices + h).contiguous(), a.vals,
              a.n_cols + 2 * h)
    x = _vec(rng, win.n_cols)
    kw = {"spmv": {}, "residual": {"b": b}, "correct": {"v": v},
          "jacobi": {"b": b, "s": s, "x_base": h}}[mode]
    got = _csr_launch(win, x, mode, vec, **kw)
    want = csr_spmv.csr_spmv_plain(win, x, mode, **kw)
    _check(got, want, 1e-5)
    if mode == "jacobi":
        assert torch.equal(csr_spmv.jacobi(win, x, b, s, x_base=h),
                           _csr_launch(win, x, mode, win.vec, **kw))
        with pytest.raises(ValueError):
            csr_spmv.jacobi(win, x, b, s, x_base=2 * h + 1)


@pytest.fixture(scope="module")
def pmis_mesh():
    """A 24³ PMIS hierarchy on 4 shards of the card (L0 and L1 in halo
    mode, the ``remote_halo`` windows)."""
    _need_cuda()
    return amg.dist_pmis_setup(amg.poisson3d_7pt(24), 4, PARAMS,
                               mesh=amg.ShardMesh(4, "cuda"),
                               agg_rows_per_dev=256, transport="remote")


@pytest.mark.parametrize("mode", ["spmv", "residual", "jacobi"])
def test_csr_kernel_on_shard_windows_matches_twin(pmis_mesh, mode):
    """Every sharded level's operator, shard by shard on its exchanged
    window (``remote_halo``), against the twin on the same window."""
    from omp_amg_tpu_torch.parallel.dist import DistOp, _windows

    rng = np.random.default_rng(12)
    checked = 0
    for lv in pmis_mesh.levels:
        op = lv.a
        if not isinstance(op, DistOp):
            continue
        xs = [_vec(rng, op.m_in) for _ in op.blocks]
        for i, (blk, (w, base)) in enumerate(zip(op.blocks,
                                                 _windows(op, xs))):
            b = _vec(rng, blk.n_rows)
            kw = {"spmv": {}, "residual": {"b": b},
                  "jacobi": {"b": b, "s": lv.s[i]}}[mode]
            before = csr_spmv.launches
            got = (csr_spmv.spmv(blk, w) if mode == "spmv" else
                   csr_spmv.residual(blk, w, b) if mode == "residual" else
                   csr_spmv.jacobi(blk, w, b, lv.s[i], x_base=base))
            assert csr_spmv.launches == before + 1
            want = csr_spmv.csr_spmv_plain(
                blk, w, mode, x_base=base if mode == "jacobi" else 0, **kw)
            _check(got, want, 1e-5)
            checked += 1
    assert checked >= 8


def test_pmis_mesh_solve_matches_cpu_iterations():
    _need_cuda()
    a = amg.poisson3d_7pt(32)
    b = amg.default_rhs(a, seed=0)
    infos = []
    for device in ("cuda", "cpu"):
        solver = amg.AMGSolver(a, PARAMS, mesh=amg.ShardMesh(4, device),
                               device=device, transport="remote",
                               agg_rows_per_dev=512)
        assert solver.stats()["sharded"][0]
        solver.solve(b, tol=1e-8)
        infos.append(solver.last_info)
    assert infos[0]["inner_iters"] == infos[1]["inner_iters"]
    assert infos[0]["outer_iters"] == infos[1]["outer_iters"]
    assert infos[0]["rel_residual"] <= 1e-8


def _stencil_offsets(dims, points):
    """Flat offsets of a 2D 9-point or 3D 7-/27-point stencil on ``dims``."""
    strides = [int(np.prod(dims[i + 1:])) for i in range(len(dims))]
    taps = np.stack(np.meshgrid(*[[-1, 0, 1]] * len(dims), indexing="ij"),
                    -1).reshape(-1, len(dims))
    if points == 7:
        taps = taps[np.abs(taps).sum(1) <= 1]
    return tuple(sorted(int(t @ strides) for t in taps))


def _dia_case(name):
    """(operator, x, x_base) of one ``dia_spmv`` path case, f32 values."""
    rng = np.random.default_rng(10)
    if name == "27pt":
        dims, offs, base, extra = (24, 20, 16), _stencil_offsets(
            (24, 20, 16), 27), 0, 0
    elif name == "2d9pt":
        dims, offs, base, extra = (96, 100), _stencil_offsets((96, 100), 9), \
            0, 0
    elif name == "n%8!=0":
        dims, offs, base, extra = (13, 17, 19), _stencil_offsets(
            (13, 17, 19), 7), 0, 0
    elif name == "odd x_base":
        dims, offs, base, extra = (16, 16, 16), _stencil_offsets(
            (16, 16, 16), 7), 257, 520
    else:   # 64 diagonals
        dims, base, extra = (8192,), 0, 0
        offs = tuple(sorted(rng.choice(np.arange(-600, 601), 64,
                                       replace=False).tolist()))
    n = int(np.prod(dims))
    a = Dia(data=torch.from_numpy(rng.standard_normal((len(offs), n))
                                  .astype(np.float32)).cuda(), offsets=offs)
    return a, _vec(rng, n + extra), base


DIA_CASES = ["27pt", "2d9pt", "n%8!=0", "odd x_base", "64 diagonals"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["spmv", "residual", "jacobi"])
@pytest.mark.parametrize("name", DIA_CASES)
def test_dia_kernel_both_paths_bitwise_twin(name, mode, dtype):
    """The wrapper's path, and each path forced through the C entry point
    where its operands allow it: bitwise the twin."""
    _need_cuda()
    from omp_amg_tpu_torch._build import cuda_kernels

    a, x, base = _dia_case(name)
    a = Dia(data=a.data.to(dtype).contiguous(), offsets=a.offsets)
    rng = np.random.default_rng(11)
    b, s = _vec(rng, a.n_rows), _vec(rng, a.n_rows)
    kw = {"spmv": {}, "residual": {"b": b}, "jacobi": {"b": b, "s": s}}[mode]
    want = dia_spmv.dia_spmv_plain(a, x, mode, x_base=base, **kw)
    before = dia_spmv.launches, dia_spmv.scalar_launches
    got = getattr(dia_spmv, mode)(a, x, *kw.values(), x_base=base)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    vector = dia_spmv.vector_path(a, x, base, tuple(kw.values()), sms)
    assert (dia_spmv.launches - before[0],
            dia_spmv.scalar_launches - before[1]) == (1, int(not vector))
    _check(got, want, 0.0)
    rows = 16 // a.data.element_size()
    operands_fit = a.n_rows % rows == 0 and base % rows == 0
    assert operands_fit == dia_spmv.vector_path(a, x, base,
                                                tuple(kw.values()), 0)
    for vec in (0, 1) if operands_fit else (0,):
        out = torch.empty(a.n_rows, device="cuda")
        rc = cuda_kernels().dia_spmv_launch(
            {"spmv": 0, "residual": 1, "jacobi": 2}[mode],
            int(dtype == torch.bfloat16), vec, a.n_rows, len(a.offsets),
            a.offsets_i32, a.data.data_ptr(), x.data_ptr(), base,
            x.numel(), None if "b" not in kw else b.data_ptr(),
            None if "s" not in kw else s.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        _check(out, want, 0.0)
    if not operands_fit:   # the vector path refuses such operands
        out = torch.empty(a.n_rows, device="cuda")
        assert cuda_kernels().dia_spmv_launch(
            0, int(dtype == torch.bfloat16), 1, a.n_rows, len(a.offsets),
            a.offsets_i32, a.data.data_ptr(), x.data_ptr(), base,
            x.numel(), None, None, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream) != 0


OPTION_CASES = {
    "structured_chebyshev": ({"smoother": "chebyshev"}, True, {}),
    "pmis_chebyshev": ({"coarsening": "pmis", "smoother": "chebyshev"},
                       False, {}),
    "structured_l1jacobi_f": ({"smoother": "l1jacobi", "cycle": "f"}, True,
                              {}),
    "structured_w": ({"cycle": "w"}, True, {}),
    "pmis_w": ({"coarsening": "pmis", "cycle": "w"}, False, {}),
    "structured_inv": ({"coarse_solver": "inv", "coarse_size": 400}, True,
                       {}),
    "pmis_inv": ({"coarsening": "pmis", "coarse_solver": "inv",
                  "coarse_size": 400}, False, {}),
    "structured_pipelined": ({}, True, {"variant": "pipelined"}),
    "pmis_pipelined": ({"coarsening": "pmis"}, False,
                       {"variant": "pipelined"}),
    "structured_device_residual": ({}, True, {"residual": "device"}),
    "pmis_device_residual": ({"coarsening": "pmis"}, False,
                             {"residual": "device"}),
}


@pytest.mark.parametrize("case", list(OPTION_CASES))
def test_gpu_option_solve_matches_cpu_iterations(case):
    _need_cuda()
    kw, structured, solve_kw = OPTION_CASES[case]
    a = amg.poisson3d_7pt(32)
    b = amg.default_rhs(a, seed=0)
    infos = []
    for device in ("cuda", "cpu"):
        solver = amg.AMGSolver(a, amg.AMGParams(**kw), device=device,
                               grid=(32,) * 3 if structured else None)
        solver.solve(b, tol=1e-8, **solve_kw)
        infos.append(solver.last_info)
    assert infos[0]["inner_iters"] == infos[1]["inner_iters"]
    assert infos[0]["outer_iters"] == infos[1]["outer_iters"]
    assert infos[0]["rel_residual"] <= 1e-8
    assert infos[0]["residual"] == solve_kw.get("residual", "device")


def test_device_result_bitwise_equals_host_copy():
    _need_cuda()
    a = amg.poisson3d_7pt(32)
    b = amg.default_rhs(a, seed=0)
    solver = amg.AMGSolver(a, amg.AMGParams(), grid=(32,) * 3)
    x = solver.solve(b, tol=1e-8, residual="device")
    xt = solver.solve(b.cuda(), tol=1e-8, residual="device",
                      device_result=True)
    assert xt.is_cuda and xt.dtype == torch.float64
    assert np.array_equal(xt.cpu().numpy(), x)


@pytest.mark.parametrize("kw,variant", [({"smoother": "chebyshev"},
                                         "standard"),
                                        ({}, "pipelined")])
def test_sharded_option_solve_matches_cpu_iterations(kw, variant):
    _need_cuda()
    a = amg.poisson3d_7pt(24)
    b = amg.default_rhs(a, seed=0)
    infos = []
    for device in ("cuda", "cpu"):
        solver = amg.AMGSolver(a, amg.AMGParams(**kw), grid=(24, 24, 24),
                               mesh=amg.ShardMesh(4, device), device=device,
                               transport="remote")
        solver.solve(b, tol=1e-8, variant=variant)
        infos.append(solver.last_info)
    assert infos[0]["inner_iters"] == infos[1]["inner_iters"]
    assert infos[0]["outer_iters"] == infos[1]["outer_iters"]
    assert infos[0]["rel_residual"] <= 1e-8


def test_gpu_refresh_matches_cpu_refresh():
    """The value-only refresh on the card against the same refresh on the
    CPU (cold ×1.7, whose ext+i ties flip, then warm ×0.5): the same host
    values, so every tensor bitwise, the index tensors the cached ones; the
    refreshed solve's counts equal the CPU's."""
    _need_cuda()
    a = amg.poisson3d_7pt(24)
    hiers = {}
    for device in ("cuda", "cpu"):
        cache = amg.SetupCache()
        h0 = amg.amg_setup(a, PARAMS, device=device, cache=cache)
        for s in (1.7, 0.5):
            h = amg.amg_refresh(amg.Dia(data=a.data * s, offsets=a.offsets,
                                        dims=a.dims), cache)
        for l0, lv in zip(h0.levels, h.levels):
            assert lv.p.indices is l0.p.indices and lv.r.indptr is l0.r.indptr
        hiers[device] = h
    g, c = hiers["cuda"], hiers["cpu"]
    assert g.device.type == "cuda"
    for lg, lc in zip(g.levels, c.levels):
        for name in ("a", "p", "r"):
            og, oc = getattr(lg, name), getattr(lc, name)
            for f in ("data", "indptr", "indices", "vals"):
                if hasattr(oc, f):
                    assert torch.equal(getattr(og, f).cpu(), getattr(oc, f))
        assert torch.equal(lg.s.cpu(), lc.s)
    assert torch.equal(g.coarse_chol.cpu(), c.coarse_chol)
    b = amg.default_rhs(a, seed=0).cuda()
    counts = [amg.amg_pcg(h.levels[0].a, b.to(h.device), h, tol=1e-6,
                          maxiter=100).iters for h in (g, c)]
    assert counts[0] == counts[1]


def test_cli_on_the_card(capsys, tmp_path):
    """``cli.main`` with ``--device cuda`` (the default): the structured
    default launches const_stencil and dia_spmv, a --matrix run csr_spmv;
    both certify, and report the card as the backend."""
    _need_cuda()
    import json

    from omp_amg_tpu_torch import cli

    path = str(tmp_path / "a.mtx")
    amg.write_matrix_market(path, amg.poisson3d_7pt(16))
    for args, used in ((["--problem", "3d7pt", "--n", "32"],
                        (const_stencil, dia_spmv)),
                       (["--matrix", path], (csr_spmv,))):
        for mod in used:
            mod.launches = 0
        assert cli.main(args + ["--json"]) == 0
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert summary["backend"] == "cuda"
        assert summary["true_rel_residual"] <= 1e-8
        assert all(mod.launches > 0 for mod in used)


# --- the captured PCG blocks (solvers/graph.py) -----------------------------

def _same_result(want, got):
    assert got.iters == want.iters
    assert got.history == want.history
    assert got.rel_residual == want.rel_residual
    xs = got.x if isinstance(got.x, list) else [got.x]
    ws = want.x if isinstance(want.x, list) else [want.x]
    assert all(torch.equal(u, v) for u, v in zip(xs, ws))


@pytest.mark.parametrize("variant", ["standard", "pipelined", "cg"])
@pytest.mark.parametrize("path", ["pmis", "structured"])
def test_captured_pcg_bitwise_per_iteration_loop(path, variant):
    """The captured blocks give the per-iteration loop's count, history and
    x bit for bit, on the first (capturing) solve and on a replay at
    another tolerance; the counters count the launches executed: the eager
    warm-up's start and block before the first capture, then per replay the
    captured launches; the kernels took the warm-up's paths."""
    _need_cuda()
    from omp_amg_tpu_torch.solvers import graph as G

    a = amg.poisson3d_7pt(32)
    grid = (32,) * 3 if path == "structured" else None
    hier = amg.amg_setup(a, PARAMS if grid is None else amg.AMGParams(),
                         device="cuda", grid=grid)
    b = amg.default_rhs(a, seed=0).cuda()
    a0 = hier.levels[0].a
    owner = a0 if variant == "cg" else hier

    def solve(tol, **kw):
        if variant == "cg":
            return amg.cg(a0, b, tol=tol, **kw)
        return amg.amg_pcg(a0, b, hier, tol=tol, variant=variant, **kw)

    for warm, tol in ((1, 1e-6), (0, 1e-4)):
        want = solve(tol, graph=False)
        before = G.counts()
        got = solve(tol)
        torch.cuda.synchronize()
        _same_result(want, got)
        (stats,) = G.graph_stats(owner).values()
        assert not stats["path_changed"]
        runner = next(iter(owner._graphs.values()))
        added = {k: v - before[k] for k, v in G.counts().items()}
        blocks = -(-max(got.iters, 1) // G.BLOCK) + warm
        assert added == {k: (1 + warm) * runner.start_inc[k]
                         + blocks * runner.block_inc[k] for k in added}
    assert stats["solves"] == 2 and stats["pool_bytes"] >= 0


@pytest.mark.parametrize("variant", ["standard", "pipelined"])
@pytest.mark.parametrize("path", ["pmis", "structured"])
def test_captured_sharded_pcg_bitwise_per_iteration_loop(path, variant):
    _need_cuda()
    from omp_amg_tpu_torch.parallel.dist import make_dist_solver
    from omp_amg_tpu_torch.solvers import graph as G

    a = amg.poisson3d_7pt(32)
    mesh = amg.ShardMesh(4, "cuda")
    solver = amg.AMGSolver(
        a, PARAMS if path == "pmis" else amg.AMGParams(), mesh=mesh,
        grid=None if path == "pmis" else (32,) * 3, transport="remote",
        agg_rows_per_dev=64)
    dh = solver.hierarchy
    bs = mesh.shard(amg.default_rhs(a, seed=0))
    want = make_dist_solver(mesh, dh, tol=1e-6, variant=variant,
                            graph=False)(dh, bs)
    got = make_dist_solver(mesh, dh, tol=1e-6, variant=variant)(dh, bs)
    _same_result(want, got)
    (stats,) = G.graph_stats(dh).values()
    assert not stats["path_changed"]
    x0 = solver.solve(amg.default_rhs(a, seed=1), graph=False)
    info0 = dict(solver.last_info)
    x1 = solver.solve(amg.default_rhs(a, seed=1))
    assert solver.last_info["inner_iters"] == info0["inner_iters"]
    assert np.array_equal(x0, x1)


def test_captured_solve_after_refresh_drops_graphs():
    """A refresh drops the graphs of the hierarchy it replaces; the captured
    solve on the refreshed hierarchy takes a fresh solver's counts."""
    _need_cuda()
    import gc
    import weakref

    a = amg.poisson3d_7pt(32)
    b = amg.default_rhs(a, seed=0)
    solver = amg.AMGSolver(a, PARAMS, refreshable=True)
    solver.solve(b)
    old = solver.hierarchy
    assert len(old._graphs) == 1
    alive = weakref.ref(next(iter(old._graphs.values())))
    a2 = amg.Dia(data=a.data * 2.0, offsets=a.offsets, dims=a.dims)
    solver.refresh(a2)
    gc.collect()
    assert alive() is None and "_graphs" not in old.__dict__
    solver.solve(b)
    fresh = amg.AMGSolver(a2, PARAMS)
    fresh.solve(b)
    assert solver.last_info["inner_iters"] == fresh.last_info["inner_iters"]
    assert solver.last_info["outer_iters"] == fresh.last_info["outer_iters"]


def test_structured_refresh_captures_into_the_pool_it_passes_on():
    """A structured refresh per step (A + 2^-j·I, the device flavor): the
    dropped graphs' memory pool passes to the refreshed hierarchy, whose
    capture (in the refresh: the solve captures nothing) reuses its memory
    (it adds under a quarter of what the first capture took), its
    captured launches take the paths of the first capture's warm-up, and
    its certified solves take a fresh solver's counts."""
    _need_cuda()
    from omp_amg_tpu_torch.solvers import graph as G

    n = 64
    a = amg.poisson3d_7pt(n)
    b = amg.default_rhs(a, seed=0).cuda().double()
    params = amg.AMGParams(coarse_size=8)
    solver = amg.AMGSolver(a, params, grid=(n,) * 3, flavor="device",
                           refreshable=True)
    solver.solve(b, device_result=True)
    pool = solver.hierarchy.__dict__["_graph_pool"]
    (first,) = G.graph_stats(solver.hierarchy).values()
    for j in (0, 3, 10):
        data = np.array(a.data, np.float64)
        data[list(a.offsets).index(0)] += 2.0 ** -j
        a_j = amg.Dia(data=data, offsets=a.offsets, dims=a.dims)
        solver.refresh(a_j)
        assert solver.hierarchy.__dict__["_graph_pool"] is pool
        # the refresh captured the solve's graphs: the solve captures none
        (before,) = G.graph_stats(solver.hierarchy).values()
        assert before["captured"] and before["solves"] == 0
        solver.solve(b, device_result=True)
        (stats,) = G.graph_stats(solver.hierarchy).values()
        assert stats["capture_s"] == before["capture_s"]
        assert stats["captured"] and not stats["path_changed"]
        assert stats["pool_bytes"] < first["pool_bytes"] / 4
        fresh = amg.AMGSolver(a_j, params, grid=(n,) * 3, flavor="device")
        fresh.solve(b, device_result=True)
        assert solver.last_info["inner_iters"] == \
            fresh.last_info["inner_iters"]
        assert solver.last_info["rel_residual"] <= 1e-8
    assert solver.refresh_counts == {"refreshed": 3, "fell_back": 0}


def _same_hierarchy(x, y, where="hierarchy"):
    """Bitwise equality of two hierarchies, walked field by field."""
    assert type(x) is type(y), where
    if isinstance(x, torch.Tensor):
        assert x.dtype == y.dtype and x.shape == y.shape, where
        assert torch.equal(x, y), where
    elif isinstance(x, np.ndarray):
        assert x.dtype == y.dtype and np.array_equal(x, y), where
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _same_hierarchy(getattr(x, f.name), getattr(y, f.name),
                            f"{where}.{f.name}")
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(y), where
        for i, (u, v) in enumerate(zip(x, y)):
            _same_hierarchy(u, v, f"{where}[{i}]")
    else:
        assert x == y, where


@pytest.mark.parametrize("maker,n", [(amg.poisson3d_7pt, 64),
                                     (amg.poisson3d_27pt, 32)])
def test_structured_refresh_graphs_replay_the_loop(maker, n):
    """The first refresh runs the pinned loop and captures its device work
    (``RefreshGraphs``); every later refresh replays those graphs, and its
    hierarchy is bitwise the loop's on the same operator (planes, dinv,
    λmax, s, forms, coarse factor), for shifts 2^-j, j 0, 2, 5, 10. A
    product that keeps other taps is left to the loop."""
    _need_cuda()
    from omp_amg_tpu_torch.amg.hierarchy import _amg_setup_structured

    a = maker(n)

    def shifted(s):
        data = np.array(a.data, np.float64)
        data[list(a.offsets).index(0)] += s
        return amg.Dia(data=data, offsets=a.offsets, dims=a.dims)

    solver = amg.AMGSolver(a, amg.AMGParams(coarse_size=8), grid=a.dims,
                           flavor="device", refreshable=True)
    cache = solver._cache
    solver.refresh(shifted(1.0))
    assert cache.graphs is not None and cache.graph_refreshes == 0
    for i, j in enumerate((0, 2, 5, 10)):
        a_j = shifted(2.0 ** -j)
        solver.refresh(a_j)
        assert cache.graph_refreshes == i + 1
        got = solver.hierarchy
        want = _amg_setup_structured(a_j, cache.dims, cache.params,
                                     got.device, False, cache.steps,
                                     pinned=cache)
        _same_hierarchy(got, want)
    # a level whose product keeps another tap: the loop decides
    lv = cache.graphs.levels[0]
    cache.graphs.levels[0] = lv._replace(keep=lv.keep[1:])
    solver.refresh(shifted(0.5))
    assert cache.graph_refreshes == 4
    assert solver.refresh_counts == {"refreshed": 6, "fell_back": 0}


def test_capture_failure_raises():
    """A step that reads the device under capture fails the capture, and
    the error reaches the caller: no eager fallback."""
    _need_cuda()
    from omp_amg_tpu_torch.solvers import graph as G

    def start(b, tol, x0):
        hist, k = G.new_history(4, torch.linalg.vector_norm(b))
        return dict(x=b.clone(), k=k, active=k < 4, hist=hist)

    def step(st, masked):
        float(st["k"])          # a host read: not capturable
        k, active = G.advance(st, 4, st["active"])
        return dict(st, k=k, active=active)

    class Owner:
        pass

    program = G.Program(start, step, lambda st: st)
    with pytest.raises(RuntimeError):
        G.run(program, torch.ones(8, device="cuda"), 1e-6, owner=Owner(),
              key="host-read")


DEVICE_SETUPS = {
    "pmis": (amg.AMGParams(coarsening="pmis", interp="direct"), None),
    "structured": (amg.AMGParams(), (32, 32, 32)),
}


@pytest.mark.parametrize("path", list(DEVICE_SETUPS))
def test_device_flavor_setup_matches_cpu(path):
    """``flavor="device"`` on the card against the same setup on the CPU at
    32³: C/F states bitwise, every level's planes within 1e-6 of the scale,
    the same forms and PCG counts."""
    _need_cuda()
    params, grid = DEVICE_SETUPS[path]
    a = amg.poisson3d_7pt(32)
    runs = {dev: amg.amg_setup(a, params, grid=grid, device=dev,
                               flavor="device", keep_host=True)
            for dev in ("cuda", "cpu")}
    (hg, sg), (hc, sc) = runs["cuda"], runs["cpu"]
    assert len(hg.levels) == len(hc.levels)
    for x, y in zip(sg.states, sc.states):
        np.testing.assert_array_equal(x, y)
    for og, oc in zip(sg.ops[1:], sc.ops[1:]):
        assert abs(og - oc).max() <= 1e-6 * abs(oc).max()
    for lg, lc in zip(hg.levels, hc.levels):
        assert type(lg.a) is type(lc.a)
        np.testing.assert_allclose(lg.lmax, lc.lmax, rtol=1e-5)
    b = amg.default_rhs(a, seed=0)
    iters = {dev: amg.amg_pcg(hg.levels[0].a if dev == "cuda"
                              else hc.levels[0].a, b.to(dev), h, tol=1e-6,
                              maxiter=100).iters
             for dev, h in (("cuda", hg), ("cpu", hc))}
    assert iters["cuda"] == iters["cpu"]


def test_captured_solve_kernels_fall_under_start_or_block(hier):
    """Under ``torch.profiler`` the kernels of a captured solve's replays
    are put down to the program's ``graph.start`` or ``graph.block`` span:
    through the host event each links to, else (a profiler whose events
    carry no link) through the ``cudaGraphLaunch`` that launched it, the
    same correlation id."""
    import bisect
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a = hier.levels[0].a
    b = _vec(np.random.default_rng(5), a.n_rows)
    amg.amg_pcg(a, b, hier, tol=1e-6)          # captures
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = amg.amg_pcg(a, b, hier, tol=1e-6)
        torch.cuda.synchronize()
    assert res.iters > 0
    host, device = [], []
    for e in prof.events():
        (host if e.device_type == DeviceType.CPU else device).append(e)
    spans = sorted(((e.time_range.start, -e.time_range.end, e.name)
                    for e in host if e.name.startswith("graph.")))
    starts = [s for s, _, _ in spans]

    def link(e):
        return getattr(e, "linked_correlation_id", 0) or 0

    linked = {e.id: e.time_range.start for e in host
              if not link(e) and not e.name.startswith("cu")}
    launch = {e.id: e for e in host if link(e) or e.name.startswith("cu")}

    def innermost(t):
        for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            s, neg_end, name = spans[j]
            if -neg_end >= t:
                return name
        return None

    where = collections.Counter()
    for k in device:
        if getattr(k, "is_user_annotation", False) or \
                k.name.startswith("graph."):
            continue
        call = launch.get(k.id)
        if call is None or call.name != "cudaGraphLaunch":
            continue                    # not a replay's kernel
        at = linked.get(link(k)) if link(k) else None
        at = call.time_range.start if at is None else at
        where[innermost(at)] += 1
    assert where["graph.start"] > 0 and where["graph.block"] > 0
    assert set(where) == {"graph.start", "graph.block"}


def test_hash01_on_the_card_bitwise_cpu():
    _need_cuda()
    from omp_amg_tpu_torch.amg.pmis import hash01

    idx = torch.cat([torch.arange(1 << 20), torch.tensor([2**31 - 1])])
    assert torch.equal(hash01(idx.cuda()).cpu(), hash01(idx))


def test_device_to_const_dia_matches_host():
    _need_cuda()
    from omp_amg_tpu_torch.sparse.formats import dia_to_device

    for a in (amg.poisson3d_7pt(32), amg.poisson3d_27pt(32),
              amg.poisson3d_7pt(32, device="cuda")):
        dev = to_const_dia(dia_to_device(a, "cuda"))
        data = a.data.cpu().numpy() if isinstance(a.data, torch.Tensor) \
            else a.data
        host = to_const_dia(Dia(data=data, offsets=a.offsets, dims=a.dims),
                            "cuda")
        assert dev is not None and dev.coeffs == host.coeffs
        assert dev.taps == host.taps and dev.device == host.device
    lv = amg.amg_setup(amg.poisson3d_7pt(32), amg.AMGParams(),
                       grid=(32,) * 3, device="cuda").levels[1].a
    assert to_const_dia(Dia(data=lv.data.float(), offsets=lv.offsets,
                            dims=lv.dims)) is None


# --- the cross-process form of remote_halo (slice 13) ------------------------

def test_remote_halo_outer_strips_match_twin():
    """The kernel's two outer table entries (the cross-process form) read
    in one process from ordinary tensors: exact against the twin with the
    same strips, on both paths, and zero-filled where an entry is null."""
    _need_cuda()
    rng = np.random.default_rng(3)
    for n, nl, nr in ((4096, 256, 128), (1001, 7, 5)):
        srcs = [_vec(rng, n) for _ in range(3)]
        lo, hi = _vec(rng, nl), _vec(rng, nr)
        for outer, plain in (((lo.data_ptr(), hi.data_ptr()), (lo, hi)),
                             ((None, hi.data_ptr()), (None, hi)),
                             ((lo.data_ptr(), None), (lo, None))):
            before = (remote_halo.launches, remote_halo.ipc_launches)
            got = remote_halo.remote_halo_window(srcs, nl, nr, outer=outer)
            assert (remote_halo.launches, remote_halo.ipc_launches) == (
                before[0] + 1, before[1] + 1)
            want = remote_halo.remote_halo_window_plain(srcs, nl, nr, *plain)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


_IPC_CHILD = r"""
import json, sys
import numpy as np
import torch
from omp_amg_tpu_torch.parallel.multihost import global_mesh, maybe_initialize
from omp_amg_tpu_torch.ops import remote_halo
from omp_amg_tpu_torch._build import cuda_kernels

assert maybe_initialize()
mesh = global_mesh(2)                      # two ranks on the one card
n, nl, nr = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
rng = np.random.default_rng(5)
full = torch.from_numpy(rng.standard_normal(mesh.size * n)
                        .astype(np.float32)).cuda()
xs = mesh.shard(full)
res = {}
# the mailbox round trip: my neighbours' posted strips, read back here
# through the buffers opened by CUDA IPC
box = remote_halo.Mailboxes(mesh)
box._grow(nl + nr)
lib = cuda_kernels()
stream = torch.cuda.current_stream().cuda_stream
assert lib.remote_halo_post(box.own, xs[0].data_ptr(), nr, xs[-1].data_ptr(),
                            n, nl, stream) == 0
box._quiesce()
shards = full.view(mesh.size, n)
ok = []
for ptr, rank in ((box.left, mesh.rank - 1), (box.right, mesh.rank + 1)):
    if not ptr:
        continue
    got = torch.empty(nr + nl, device="cuda")
    assert lib.remote_halo_post(got.data_ptr(), ptr, nr + nl, ptr, 0, 0,
                                stream) == 0
    torch.cuda.synchronize()
    mine = shards[rank * mesh.local:(rank + 1) * mesh.local]
    want = torch.cat([mine[0][:nr], mine[-1][n - nl:]])
    ok.append(bool(torch.equal(got, want)))
res["round_trip"] = ok
box.close()
# the cross-process windows against the one-process kernel on all shards
for rep in range(3):                       # both mailbox slots, and again
    got = mesh.remote_windows(xs, nl, nr)
    want = remote_halo.remote_halo_window(list(shards), nl, nr)[
        mesh.first:mesh.first + mesh.local]
    torch.cuda.synchronize()
    res.setdefault("windows", []).append(bool(torch.equal(got, want)))
res["ipc_launches"] = remote_halo.ipc_launches
mesh.close()
print("RESULT " + json.dumps(res), flush=True)
"""


def test_remote_halo_across_two_processes_on_one_card():
    """Two ranks on the one card (gloo, CUDA IPC mailboxes): each reads its
    neighbour's posted strips back through the opened buffer (the IPC round
    trip), and its cross-process windows are exactly the one-process
    kernel's windows of the same shards, over both mailbox slots."""
    _need_cuda()
    import json
    import os
    import socket
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for n, nl, nr in ((65536, 4096, 4096), (999, 13, 7)):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port_ = s.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, "-c", _IPC_CHILD, str(n), str(nl), str(nr)],
            env=dict(os.environ, OMP_AMG_COORDINATOR=f"127.0.0.1:{port_}",
                     OMP_AMG_NUM_PROCS="2", OMP_AMG_PROC_ID=str(r)),
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append((p.communicate(timeout=120), p.returncode))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for (out, err), rc in outs:
            assert rc == 0, err[-3000:]
            res = json.loads(next(ln for ln in out.splitlines()
                                  if ln.startswith("RESULT "))[7:])
            assert res["round_trip"] == [True]
            assert res["windows"] == [True] * 3
            assert res["ipc_launches"] == 3


# --- the tiled CSR kernel: bitwise the CSR kernel on the same operator ---

def _banded_csr(rng, n, lo, hi, reach, empty_every=97):
    """Rows of ``lo``..``hi`` distinct columns within ``reach`` of the row
    (neighbouring rows share columns, as the coarse PMIS rows do), every
    ``empty_every``-th row empty: a V = 8 case of the tiled form's rule."""
    import scipy.sparse as sp

    lens = rng.integers(lo, hi + 1, n)
    lens[::empty_every] = 0
    rows = np.repeat(np.arange(n), lens)
    cols = np.clip(rows + rng.integers(-reach, reach + 1, rows.size), 0,
                   n - 1)
    m = sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(n, n))
    m.sum_duplicates()
    return csr_from_scipy(m, device="cuda")


@pytest.fixture(scope="module")
def tile_cases():
    """A₁ and A₂ of the 48³ PMIS hierarchy (V = 16 and 32) and a banded
    random operator (V = 8), as CSRs."""
    _need_cuda()
    h = amg.amg_setup(amg.poisson3d_7pt(48), PARAMS, device="cuda")
    cases = {"A1": h.levels[1].a, "A2": h.levels[2].a,
             "banded": _banded_csr(np.random.default_rng(5), 60_000, 16, 31,
                                   300)}
    assert [c.vec for c in cases.values()] == [16, 32, 8]
    return cases


def _tile_pair(c, t, mode, x, v, b, s):
    from omp_amg_tpu_torch.ops import tile_csr as tile_ops

    before = tile_ops.launches
    args = {"spmv": (x,), "residual": (x, b), "correct": (x, v),
            "jacobi": (x, b, s)}[mode]
    got = getattr(tile_ops, mode)(t, *args)
    assert tile_ops.launches == before + 1
    want = getattr(csr_spmv, mode)(c, *args)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("window", [6144, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["spmv", "residual", "correct", "jacobi"])
@pytest.mark.parametrize("case", ["A1", "A2", "banded"])
def test_tile_kernel_bitwise_csr_kernel(tile_cases, case, mode, dtype,
                                        window):
    """Every mode × value type × lane width of the rule, at the builder's
    window and at one that cuts many small tiles: the tiled kernel's bits
    are the CSR kernel's, and near the twin's."""
    from omp_amg_tpu_torch.ops import tile_csr as tile_ops
    from omp_amg_tpu_torch.sparse.formats import tile_csr

    c = tile_cases[case]
    c = Csr(c.indptr, c.indices, c.vals.to(dtype), c.n_cols)
    t = tile_csr(c, window=window)
    assert t is not None and t.window <= window and t.vec == c.vec
    rng = np.random.default_rng(3)
    x, v, b, s = (_vec(rng, c.n_rows) for _ in range(4))
    got, want = _tile_pair(c, t, mode, x, v, b, s)
    assert torch.equal(got, want)
    _check(got, tile_ops.tile_csr_plain(t, x, mode, v=v, b=b, s=s), 1e-5)


@pytest.mark.parametrize("mode", ["spmv", "residual", "correct", "jacobi"])
def test_tile_kernel_bitwise_on_unaligned_views(tile_cases, mode):
    """Operands that are views off a 16-byte boundary take the element
    copies: the same bits."""
    from omp_amg_tpu_torch.sparse.formats import tile_csr

    c = tile_cases["A1"]
    t = tile_csr(c)
    rng = np.random.default_rng(4)
    n = c.n_rows
    x, v, b, s = (_vec(rng, n + 1)[1:] for _ in range(4))
    vals = torch.cat([c.vals[:1], c.vals])[1:]
    c2 = Csr(c.indptr, c.indices, vals, c.n_cols)
    t2 = dataclasses.replace(t, vals=vals)
    got, want = _tile_pair(c2, t2, mode, x, v, b, s)
    assert torch.equal(got, want)


def test_certified_pmis_solve_is_the_csr_paths():
    """A certified 64³ PMIS solve on its hierarchy (every operator a CSR:
    the rule's size keeps them there) and on the same hierarchy with every
    A and R of 8 lanes or more in the tiled form: the same iterations,
    residual and answer, bit for bit."""
    _need_cuda()
    from omp_amg_tpu_torch.ops import tile_csr as tile_ops
    from omp_amg_tpu_torch.sparse.formats import tile_csr

    def tiled(op):
        return tile_csr(op) if isinstance(op, Csr) and op.vec >= 8 else op

    a = amg.poisson3d_7pt(64)
    b = amg.default_rhs(a, seed=0)
    solver = amg.AMGSolver(a, PARAMS, device="cuda")
    csr = solver.hierarchy
    assert csr.tiled == ()
    x_c = solver.solve(b, tol=1e-8)
    info_c = solver.last_info
    solver.hierarchy = dataclasses.replace(csr, levels=tuple(
        dataclasses.replace(lv, a=tiled(lv.a), r=tiled(lv.r))
        for lv in csr.levels))
    assert [(l, name) for l, name, _ in solver.hierarchy.tiled][:2] == \
        [(1, "a"), (1, "r")]
    before = tile_ops.launches
    x_t = solver.solve(b, tol=1e-8)
    info_t = solver.last_info
    assert tile_ops.launches > before
    assert info_t["inner_iters"] == info_c["inner_iters"]
    assert info_t["outer_iters"] == info_c["outer_iters"]
    assert info_t["rel_residual"] == info_c["rel_residual"] <= 1e-8
    assert np.array_equal(np.asarray(x_t), np.asarray(x_c))
