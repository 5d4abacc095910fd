"""The port's CUDA kernels on the card: each kernel × mode × value type
against its plain twin on the same CUDA tensors (``dia_spmv`` also over an
x window and on both its vector and scalar paths, ``csr_spmv`` at every
lane width on rows of 0 to 200 nonzeros, ``const_stencil`` on ragged,
one-plane, one-line, interior-block and unaligned grids at any z-chunk,
``panel_spmm`` on both of its instances, ``remote_halo``'s windows
exactly on both of its paths), and the GPU solves' iteration counts
(PMIS, PMIS with the probed Galerkin values, structured, and structured on
a 4-shard mesh; and with the Chebyshev and l1-Jacobi smoothers, the W and F
cycles, the ``inv`` coarse solve, the pipelined PCG and the device
certified loop) against the port's CPU solves. Needs an NVIDIA GPU and nvcc;
skipped elsewhere (the CPU runs only the twins). Run on the card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

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
                                         out.data_ptr(), stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    if not vec:    # the vector path refuses what it cannot take
        assert lib.remote_halo_window_launch(
            d, n, nl, nr, out.shape[1], 1, table, out.data_ptr(), stream) != 0
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
    out = []
    for l in range(len(host.p)):
        probe, _ = probe_rap.build_rap_probe(host.ops[l], host.p[l],
                                             device="cuda")
        if probe is not None:
            out.append(probe)
    return out


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


def _csr_launch(a, x, mode, vec, v=None, b=None, s=None):
    """``csr_spmv``'s C entry point at a forced lane width (the wrapper
    always passes ``a.vec``)."""
    from omp_amg_tpu_torch._build import cuda_kernels

    out = torch.empty(a.n_rows, device="cuda")
    vecs = (None if t is None else t.data_ptr() for t in (v, b, s))
    rc = cuda_kernels().csr_spmv_launch(
        {"spmv": 0, "residual": 1, "correct": 2, "jacobi": 3}[mode],
        int(a.vals.dtype == torch.bfloat16), vec, a.n_rows,
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
