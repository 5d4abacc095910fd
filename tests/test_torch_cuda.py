"""The port's CUDA kernels on the card: each kernel × mode × value type
against its plain twin on the same CUDA tensors (``dia_spmv`` also over an
x window, ``remote_halo`` exactly), and the GPU solves' iteration counts
(PMIS, PMIS with the probed Galerkin values, structured, and structured on
a 4-shard mesh) against the port's CPU solves. Needs an NVIDIA GPU and nvcc;
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


@pytest.fixture(scope="module")
def stencil():
    _need_cuda()
    a = amg.poisson3d_27pt(64, 32, 16)
    return to_const_dia(Dia(data=a.data.astype(np.float32),
                            offsets=a.offsets, dims=a.dims), device="cuda")


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


@pytest.mark.parametrize("mode", ["spmv", "residual", "jacobi", "zjr",
                                  "cja"])
def test_const_stencil_kernel_matches_twin(stencil, mode):
    rng = np.random.default_rng(2)
    x, b, p = (_vec(rng, stencil.n_rows) for _ in range(3))
    s = float(np.float32(0.137))
    before = const_stencil.launches
    got = {"spmv": lambda: const_stencil.spmv(stencil, x),
           "residual": lambda: const_stencil.residual(stencil, x, b),
           "jacobi": lambda: const_stencil.jacobi(stencil, x, b, s),
           "zjr": lambda: const_stencil.presmooth_residual(stencil, x, s),
           "cja": lambda: const_stencil.correct_jacobi(stencil, x, p, s)
           }[mode]()
    assert const_stencil.launches == before + 1
    want = const_stencil.const_stencil_plain(stencil, x, mode, b=b, p=p, s=s)
    # explicit rounding in ascending tap order: bitwise the twin
    _check(got, want, 0.0)


@pytest.mark.parametrize("dims", [(70000, 2, 40), (1, 530000, 33)])
def test_const_stencil_kernel_chunks_large_grids(dims):
    """More than 65535 planes, or more than 65535 tiles of 4 lines: the
    launcher splits the grid into chunks the launch grid can carry."""
    _need_cuda()
    nz, ny, nx = dims
    taps = ((-1, 0, 0), (0, -1, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1),
            (0, 1, 0), (1, 0, 0))
    offsets = tuple((dz * ny + dy) * nx + dx for dz, dy, dx in taps)
    a = ConstDia(coeffs=(-1.0, -1.0, -1.0, 6.0, -1.0, -1.0, -1.0),
                 offsets=offsets, taps=taps, dims=dims,
                 device=torch.empty(0, device="cuda").device)
    rng = np.random.default_rng(3)
    x, b = _vec(rng, a.n_rows), _vec(rng, a.n_rows)
    _check(const_stencil.residual(a, x, b),
           const_stencil.const_stencil_plain(a, x, "residual", b=b), 0.0)


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


@pytest.mark.parametrize("d,n,nl,nr", [(4, 131072, 16384, 16384),
                                       (3, 1000, 100, 0), (8, 4096, 0, 512),
                                       (64, 640, 64, 64)])
def test_remote_halo_exact(d, n, nl, nr):
    _need_cuda()
    rng = np.random.default_rng(8)
    srcs = [_vec(rng, n) for _ in range(d)]
    before = remote_halo.launches
    left, right = remote_halo.remote_halo(srcs, nl, nr)
    assert remote_halo.launches == before + 1
    want_l, want_r = remote_halo.remote_halo_plain(srcs, nl, nr)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(left, want_l))
    assert all(torch.equal(u, v) for u, v in zip(right, want_r))
    with pytest.raises(ValueError):
        remote_halo.remote_halo(srcs + [srcs[0]] * (65 - d), 1, 1)


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


@pytest.mark.parametrize("c", [1, 16, 32, 45, 96, 128])
def test_panel_spmm_matches_twin_on_random_operators(c):
    _need_cuda()
    rng = np.random.default_rng(4)
    for n_rows, n_cols, per_row in ((1000, 700, 9), (300, 5000, 60)):
        a = csr_from_scipy(_random_csr(rng, n_rows, n_cols, per_row),
                           device="cuda")
        x = torch.from_numpy(rng.standard_normal((n_cols, c))
                             .astype(np.float32)).cuda()
        before = panel_spmm.launches
        got = panel_spmm.spmm_panel(a, x)
        assert panel_spmm.launches == before + 1
        # explicit rounding in CSR order: bitwise the twin
        _check(got, panel_spmm.spmm_panel_plain(a, x), 0.0)


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
