"""The certified loop's float64 work through ``ops/ir_f64.py``: the
wrappers run the plain twin on CPU tensors without a launch, bit for bit the
torch forms the loop ran before (kept here as they were: the padded
per-tap ``dia_apply_f64``, ``b − y``, ``(r / rnorm).float()`` and
``x + rnorm · x_inner``), for 7-point and 27-point f64 planes, with and
without an x window, in modes spmv and residual; the checks raise;
``solve_ir_device`` and the z-slab mesh loop give the x, counts and
histories of the loop as it was.

On the card (marked ``cuda``, skipped elsewhere): each kernel against its
twin with ``torch.equal`` at 256³ 7-point, 128³ 27-point, lengths 1 and 3,
16³ + 1, an unaligned view (the scalar path) and a z-slab window at
``x_base > 0``, each path of the f64 banded kernel forced through its C
entry point; the defect against the loop's own ``(r / rnorm).float()``;
the checks on CUDA tensors, a missing library included; and a captured
certified solve (64³ 7-point structured, 32³ 27-point PMIS Chebyshev) bit
for bit the twins' loop, with one residual launch per outer pass plus one
and one defect and one update launch per inner solve. Run there with

    python -m pytest --noconftest tests/test_torch_ir_f64.py -q -m cuda
"""

import numpy as np
import pytest
import torch

import omp_amg_tpu_torch as amg
from omp_amg_tpu_torch.ops import ir_f64
from omp_amg_tpu_torch.solvers import graph as G
from omp_amg_tpu_torch.solvers.cg import amg_pcg
from omp_amg_tpu_torch.sparse.formats import Dia

torch.set_num_threads(2)


# --- the loop's torch forms, as they were ------------------------------------

def old_dia_apply_f64(offsets, data, x, x_base=0, n_rows=None):
    n = data.shape[1] if n_rows is None else n_rows
    lo = max(0, -min(offsets))
    hi = max(0, max(offsets))
    xp = torch.nn.functional.pad(x.double(), (lo, hi))
    y = torch.zeros(n, dtype=torch.float64, device=x.device)
    for k, off in enumerate(offsets):
        start = x_base + off + lo
        y = y + data[k].double() * xp[start:start + n]
    return y


def old_loop(a, b, hier, tol=1e-8, inner_tol=1e-6, maxiter=200,
             max_outer=8):
    """``solve_ir_device``'s loop before the kernels (x on the device)."""
    dev = hier.device
    offsets = tuple(int(o) for o in a.offsets)
    data = a.data if isinstance(a.data, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(a.data))
    data = data.to(dev, torch.float64)
    b = torch.as_tensor(np.asarray(b, np.float64)).to(dev)
    bnorm = float(torch.linalg.vector_norm(b))
    x = torch.zeros_like(b)
    iters, hists, rel = [], [], 0.0
    for outer in range(max_outer + 1):
        r = b - old_dia_apply_f64(offsets, data, x)
        rnorm = float(torch.linalg.vector_norm(r))
        rel = rnorm / bnorm
        if rel <= tol or outer == max_outer:
            break
        defect = (r / rnorm).float()
        res = amg_pcg(hier.levels[0].a, defect, hier,
                      tol=max(inner_tol, 0.3 * tol / rel), maxiter=maxiter)
        iters.append(res.iters)
        hists.append(res.history)
        x = x + rnorm * res.x.double()
    return x, iters, hists, rel


# --- operands ----------------------------------------------------------------

def stencil_offsets(dims, points):
    """Offsets of the 7- or 27-point stencil on a (nz, ny, nx) grid."""
    nz, ny, nx = dims
    if points == 7:
        return (-nx * ny, -nx, -1, 0, 1, nx, nx * ny)
    return tuple(dz * nx * ny + dy * nx + dx for dz in (-1, 0, 1)
                 for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def banded(n, offsets, device="cpu", seed=0, pad=0, misalign=False):
    """(A, x, b, x_base): seeded normal f64 planes of n rows, an x window of
    n + 2·pad values with the rows at ``pad``, b; with ``misalign`` every
    operand a contiguous view 8 bytes off a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    k = int(misalign)

    def tensor(m):
        full = torch.from_numpy(rng.standard_normal(m + k)).to(device)
        return full[k:]
    data = tensor(len(offsets) * n).view(len(offsets), n)
    return (Dia(data=data, offsets=tuple(offsets)), tensor(n + 2 * pad),
            tensor(n), pad)


CASES = {   # name: (rows, offsets, x window pad)
    "7pt_12": (12 ** 3, stencil_offsets((12,) * 3, 7), 0),
    "27pt_10": (10 ** 3, stencil_offsets((10,) * 3, 27), 0),
    "7pt_12_window": (12 ** 3, stencil_offsets((12,) * 3, 7), 2 * 144),
    "27pt_10_window": (10 ** 3, stencil_offsets((10,) * 3, 27), 100),
}


# --- the wrappers on CPU tensors ---------------------------------------------

@pytest.mark.parametrize("mode", ["spmv", "residual"])
@pytest.mark.parametrize("case", CASES)
def test_cpu_banded_twin_bitwise_old_form(case, mode):
    n, offs, pad = CASES[case]
    a, x, b, base = banded(n, offs, seed=n + pad)
    before = ir_f64.launches
    if mode == "spmv":
        got = ir_f64.spmv(a, x, x_base=base)
        want = old_dia_apply_f64(offs, a.data, x, x_base=base, n_rows=n)
    else:
        got = ir_f64.residual(a, x, b, x_base=base)
        want = b - old_dia_apply_f64(offs, a.data, x, x_base=base, n_rows=n)
    assert ir_f64.launches == before
    assert got.dtype == torch.float64 and torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 3, 4097])
def test_cpu_defect_and_update_twins_bitwise_old_forms(n):
    rng = np.random.default_rng(n)
    r = torch.from_numpy(rng.standard_normal(n) * 1e-3)
    rnorm = float(torch.linalg.vector_norm(r))
    x = torch.from_numpy(rng.standard_normal(n))
    xi = torch.from_numpy(rng.standard_normal(n)).float()
    want_x = x + rnorm * xi.double()
    ptr, before = x.data_ptr(), ir_f64.launches
    got = ir_f64.defect(r, rnorm)
    ir_f64.update(x, rnorm, xi)
    assert ir_f64.launches == before
    assert got.dtype == torch.float32 and torch.equal(got,
                                                      (r / rnorm).float())
    assert x.data_ptr() == ptr and torch.equal(x, want_x)    # in place


def _bad(case, device="cpu"):
    """A call that the wrappers must refuse, and its exception."""
    a, x, b, _ = banded(64, (-1, 0, 1), device)
    r, xi = b.clone(), b.float()
    wide = Dia(data=torch.zeros(65, 64, dtype=torch.float64, device=device),
               offsets=tuple(range(-32, 33)))
    strided = torch.zeros(128, dtype=torch.float64, device=device)[::2]
    cases = {
        "f32-planes": (lambda: ir_f64.residual(
            Dia(data=a.data.float(), offsets=a.offsets), x, b), TypeError),
        "numpy-planes": (lambda: ir_f64.spmv(
            Dia(data=a.data.cpu().numpy(), offsets=a.offsets), x), TypeError),
        "f32-x": (lambda: ir_f64.spmv(a, x.float()), ValueError),
        "f32-b": (lambda: ir_f64.residual(a, x, b.float()), ValueError),
        "short-b": (lambda: ir_f64.residual(a, x, b[:-1]), ValueError),
        "short-x": (lambda: ir_f64.spmv(a, x[:-1]), ValueError),
        "window-out": (lambda: ir_f64.spmv(a, x, x_base=1), ValueError),
        "strided-x": (lambda: ir_f64.spmv(
            Dia(data=a.data[:, ::2], offsets=a.offsets), strided),
            ValueError),
        "strided-b": (lambda: ir_f64.residual(a, x, torch.zeros(
            128, dtype=torch.float64, device=device)[::2]), ValueError),
        "65-diagonals": (lambda: ir_f64.spmv(wide, x), ValueError),
        "planes-shape": (lambda: ir_f64.spmv(
            Dia(data=a.data[:2], offsets=a.offsets), x), ValueError),
        "f32-r": (lambda: ir_f64.defect(r.float(), 1.0), ValueError),
        "strided-r": (lambda: ir_f64.defect(strided, 1.0), ValueError),
        "f64-xi": (lambda: ir_f64.update(x, 1.0, xi.double()), ValueError),
        "short-xi": (lambda: ir_f64.update(x, 1.0, xi[:-1]), ValueError),
        "f32-x-update": (lambda: ir_f64.update(xi, 1.0, xi), ValueError),
        "strided-update": (lambda: ir_f64.update(strided, 1.0,
                                                 xi), ValueError),
    }
    return cases[case]


BAD = ["f32-planes", "numpy-planes", "f32-x", "f32-b", "short-b", "short-x",
       "window-out", "strided-x", "strided-b", "65-diagonals",
       "planes-shape", "f32-r", "strided-r", "f64-xi", "short-xi",
       "f32-x-update", "strided-update"]


@pytest.mark.parametrize("case", BAD)
def test_checks_raise(case):
    fn, exc = _bad(case)
    before = ir_f64.launches
    with pytest.raises(exc):
        fn()
    assert ir_f64.launches == before


def test_no_kernel_for_other_devices():
    """A tensor on neither the CPU nor CUDA (meta) raises, twin and kernel
    alike untouched."""
    a, x, b, _ = banded(8, (-1, 0, 1), "meta")
    for fn in (lambda: ir_f64.residual(a, x, b),
               lambda: ir_f64.defect(b, 1.0),
               lambda: ir_f64.update(b, 1.0, b.float())):
        with pytest.raises(ValueError, match="no ir_f64 kernel"):
            fn()


def test_counter_is_a_graph_counter():
    assert ir_f64 in G.COUNTERS
    assert (ir_f64, "launches") in G.counts()


@pytest.mark.parametrize("gen,n,grid,params", [
    ("poisson3d_7pt", 16, (16,) * 3, {}),
    ("poisson3d_27pt", 12, None, {"coarsening": "pmis",
                                  "smoother": "chebyshev"}),
])
def test_solve_ir_device_equals_old_loop(gen, n, grid, params):
    a = getattr(amg, gen)(n)
    hier = amg.amg_setup(a, amg.AMGParams(**params), device="cpu", grid=grid)
    b = amg.default_rhs(a, seed=0).numpy().astype(np.float64)
    before = ir_f64.launches
    res = amg.solve_ir_device(a, b, hier, tol=1e-11, to_host=False)
    assert ir_f64.launches == before
    x, iters, hists, rel = old_loop(a, b, hier, tol=1e-11)
    assert res.outer_iters == len(iters) >= 2
    assert res.inner_iters == iters and res.histories == hists
    assert res.rel_residual == rel
    assert torch.equal(res.x, x)


def test_zslab_mesh_loop_equals_old_form(monkeypatch):
    """The certified z-slab loop on 4 CPU shards: the shard products through
    ``ir_f64.spmv`` (at each shard's window) against the loop with the old
    per-tap form in their place: x, counts and histories bit for bit."""
    a = amg.poisson3d_7pt(16)
    b = amg.default_rhs(a, seed=1)
    solver = amg.AMGSolver(a, amg.AMGParams(), grid=(16,) * 3,
                           mesh=amg.ShardMesh(4, "cpu"), device="cpu",
                           transport="ppermute", agg_rows_per_dev=64)
    calls = []
    spmv = ir_f64.spmv

    def counting(blk, w, x_base=0):
        calls.append(x_base)
        return spmv(blk, w, x_base=x_base)
    monkeypatch.setattr(ir_f64, "spmv", counting)
    x = solver.solve(b, tol=1e-10)
    got = dict(solver.last_info)
    assert got["distributed"] and got["certified_f64"]
    assert len(calls) == 4 * (got["outer_iters"] + 1)
    assert any(base > 0 for base in calls)

    def old(blk, w, x_base=0):
        return old_dia_apply_f64(blk.offsets, blk.data, w, x_base=x_base,
                                 n_rows=blk.n_rows)
    monkeypatch.setattr(ir_f64, "spmv", old)
    x_old = solver.solve(b, tol=1e-10)
    want = solver.last_info
    assert got["inner_iters"] == want["inner_iters"]
    assert got["residual_histories"] == want["residual_histories"]
    assert got["rel_residual"] == want["rel_residual"]
    np.testing.assert_array_equal(x, x_old)


# --- on the card -------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CPU runs the plain twin)")


CARD_CASES = {   # name: (rows, offsets, x window pad, misaligned)
    "7pt_256": (256 ** 3, stencil_offsets((256,) * 3, 7), 0, False),
    "27pt_128": (128 ** 3, stencil_offsets((128,) * 3, 27), 0, False),
    "len1": (1, (0,), 0, False),
    "len3": (3, (-1, 0, 1), 0, False),
    "16^3+1": (16 ** 3 + 1, stencil_offsets((16,) * 3, 7), 0, False),
    "unaligned": (16 ** 3, stencil_offsets((16,) * 3, 27), 0, True),
    "zslab_window": (64 * 64 * 16, stencil_offsets((16, 64, 64), 7),
                     64 * 64, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernels_equal_twins(case):
    """Each kernel on CUDA tensors against its twin on the same tensors:
    the f64 banded kernel in spmv and residual mode through the wrapper
    (counted) and through its C entry point, whose vector path refuses f64;
    the defect and the in-place update."""
    _need_cuda()
    from omp_amg_tpu_torch._build import cuda_kernels

    n, offs, pad, mis = CARD_CASES[case]
    a, x, b, base = banded(n, offs, "cuda", seed=n, pad=pad, misalign=mis)
    want = {"spmv": old_dia_apply_f64(offs, a.data, x, base, n)}
    want["residual"] = b - want["spmv"]
    for mode in ("spmv", "residual"):
        before = ir_f64.launches
        got = (ir_f64.spmv(a, x, base) if mode == "spmv"
               else ir_f64.residual(a, x, b, base))
        assert ir_f64.launches - before == 1
        torch.cuda.synchronize()
        assert torch.equal(got, want[mode]), mode
        for vec in (0, 1):
            out = torch.empty(n, dtype=torch.float64, device="cuda")
            rc = cuda_kernels().dia_spmv_launch(
                0 if mode == "spmv" else 1, 2, vec, n, len(offs),
                a.offsets_i32, a.data.data_ptr(), x.data_ptr(), base,
                x.numel(), None if mode == "spmv" else b.data_ptr(), None,
                out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if vec:
                assert rc != 0
                continue
            assert rc == 0, mode
            torch.cuda.synchronize()
            assert torch.equal(out, want[mode]), mode
    r = want["residual"] if not mis else b
    rnorm = float(torch.linalg.vector_norm(r))
    before = ir_f64.launches
    d = ir_f64.defect(r, rnorm)
    torch.cuda.synchronize()
    assert torch.equal(d, (r / rnorm).float())       # the loop's own form
    assert torch.equal(d, ir_f64.defect_twin(r, rnorm))
    xi = d if not mis else torch.empty(n + 1, device="cuda")[1:].copy_(d)
    xs = x[base:base + n].clone() if not mis else x[:n]
    want_x = xs + rnorm * xi.double()
    ir_f64.update(xs, rnorm, xi)
    torch.cuda.synchronize()
    assert ir_f64.launches - before == 2
    assert torch.equal(xs, want_x)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BAD)
def test_kernel_checks_raise(case):
    _need_cuda()
    fn, exc = _bad(case, "cuda")
    before = ir_f64.launches
    with pytest.raises(exc):
        fn()
    assert ir_f64.launches == before


@pytest.mark.cuda
def test_cuda_tensor_without_library_raises(monkeypatch):
    """No library, no result: a CUDA tensor never reaches the twin."""
    _need_cuda()
    from omp_amg_tpu_torch import _build

    def missing():
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels")
    monkeypatch.setattr(_build, "cuda_kernels", missing)
    a, x, b, _ = banded(64, (-1, 0, 1), "cuda")
    before = ir_f64.launches
    for fn in (lambda: ir_f64.residual(a, x, b),
               lambda: ir_f64.spmv(a, x),
               lambda: ir_f64.defect(b, 1.0),
               lambda: ir_f64.update(b, 1.0, b.float())):
        with pytest.raises(RuntimeError, match="nvcc"):
            fn()
    assert ir_f64.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["7pt_64_structured",
                                    "27pt_32_pmis_cheby"])
def test_captured_certified_solve_equals_twins(config, monkeypatch):
    """A certified solve through the kernels (the PCG captured) against the
    same solve with the twins in their place: x, inner counts, histories
    and the residual bit for bit; 3 launches per outer pass plus 1."""
    _need_cuda()
    if config == "7pt_64_structured":
        a, grid, params = amg.poisson3d_7pt(64), (64,) * 3, amg.AMGParams()
    else:
        a, grid = amg.poisson3d_27pt(32), None
        params = amg.AMGParams(coarsening="pmis", smoother="chebyshev")
    hier = amg.amg_setup(a, params, device="cuda", grid=grid)
    b = amg.default_rhs(a, seed=3).cuda().double()
    amg.solve_ir_device(a, b, hier, to_host=False)           # captures
    before = ir_f64.launches
    got = amg.solve_ir_device(a, b, hier, to_host=False)
    torch.cuda.synchronize()
    assert got.outer_iters >= 1
    assert ir_f64.launches - before == 3 * got.outer_iters + 1
    monkeypatch.setattr(ir_f64, "residual", ir_f64.residual_twin)
    monkeypatch.setattr(ir_f64, "defect", ir_f64.defect_twin)
    monkeypatch.setattr(ir_f64, "update", ir_f64.update_twin)
    before = ir_f64.launches
    want = amg.solve_ir_device(a, b, hier, to_host=False)
    torch.cuda.synchronize()
    assert ir_f64.launches == before
    assert got.inner_iters == want.inner_iters
    assert got.histories == want.histories
    assert got.rel_residual == want.rel_residual
    assert torch.equal(got.x, want.x)
    x_old, iters, hists, rel = old_loop(a, b.cpu().numpy(), hier)
    assert iters == got.inner_iters and hists == got.histories
    assert rel == got.rel_residual and torch.equal(x_old, got.x)
