"""The hierarchy's size counters, the kernels' launch counters read at once,
and the strength semantics of the 2D anisotropic 9-point operator, on the
CPU:

- ``Hierarchy.level_rows`` and ``level_nnz`` equal the rows and stored
  nonzeros of the host operators that ``amg_setup(..., keep_host=True)``
  keeps, level by level, the coarsest included, on both PMIS setups; the
  setups that do not record them leave them empty;
- ``ops.launch_counts()`` names every module of ``ops/`` that counts its
  launches, and a V-cycle on the CPU (the plain twins) launches nothing;
- −ε·u_xx − u_yy (ε = 1e-3, bilinear elements): a corner coupling is
  0.2504 of the strong y coupling, so θ = 0.25 admits the corners and
  θ = 0.5 keeps exactly the two y couplings of an interior row; θ = 0.5
  certifies in a fraction of θ = 0.25's inner iterations.
"""

import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

import omp_amg_tpu_torch as amg
from omp_amg_tpu_torch import ops
from omp_amg_tpu_torch.amg import host_setup as hs
from omp_amg_tpu_torch.sparse.formats import ell_planes_from_dia

torch.set_num_threads(2)

N2 = 64     # the 2D grid: 4096 rows, a hierarchy of several levels

SETUPS = {
    "7pt_16_host": (lambda: amg.poisson3d_7pt(16),
                    dict(coarsening="pmis"), "host"),
    "aniso9pt_64_host": (lambda: amg.aniso2d_9pt(N2),
                         dict(coarsening="pmis", theta=0.5), "host"),
    # the device flavor runs direct interpolation only
    "7pt_16_device": (lambda: amg.poisson3d_7pt(16),
                      dict(coarsening="pmis", interp="direct"), "device"),
}


@pytest.mark.parametrize("name", sorted(SETUPS))
def test_level_sizes_are_the_host_operators(name):
    make, params, flavor = SETUPS[name]
    a = make()
    hier, host = amg.amg_setup(a, amg.AMGParams(**params), device="cpu",
                               keep_host=True, flavor=flavor)
    assert hier.level_rows == tuple(op.shape[0] for op in host.ops)
    assert hier.level_nnz == tuple(op.nnz for op in host.ops)
    assert len(hier.level_rows) == len(hier.levels) + 1 >= 3
    assert hier.level_rows[:-1] == tuple(lv.a.n_rows for lv in hier.levels)
    assert hier.level_rows[-1] == hier.coarse_chol.shape[0]
    # the fine level's true nonzeros: the stencil's taps inside the grid,
    # not the DIA planes' padded length
    planes = np.asarray(a.data)
    assert hier.level_nnz[0] == int(np.count_nonzero(planes))
    assert hier.level_nnz[0] < planes.size
    # the same setup without the host record holds the same sizes
    again = amg.amg_setup(a, amg.AMGParams(**params), device="cpu",
                          flavor=flavor)
    assert (again.level_rows, again.level_nnz) == (hier.level_rows,
                                                   hier.level_nnz)


def test_setups_that_record_no_sizes_leave_them_empty():
    hier = amg.amg_setup(amg.poisson3d_7pt(16),
                         amg.AMGParams(coarsening="structured"),
                         device="cpu", grid=(16, 16, 16))
    assert hier.level_rows == () and hier.level_nnz == ()


def _modules_with_counters() -> set:
    """Every module file of ``ops/`` whose module has a ``launches``
    counter, found from the files and not from the package's own list."""
    found = set()
    for path in Path(ops.__file__).parent.glob("*.py"):
        if path.stem == "__init__":
            continue
        mod = importlib.import_module(f"omp_amg_tpu_torch.ops.{path.stem}")
        if hasattr(mod, "launches"):
            found.add(path.stem)
    return found


def test_launch_counts_names_every_kernel_module():
    from omp_amg_tpu_torch.solvers import graph

    counts = ops.launch_counts()
    assert set(counts) == _modules_with_counters()
    assert {"csr_spmv", "dia_spmv", "pcg_update", "ir_f64"} <= set(counts)
    assert all(isinstance(v, int) for v in counts.values())
    # the captured loop's replay counters read the same modules
    assert {m.__name__.rsplit(".", 1)[1] for m in graph.COUNTERS} == \
        set(counts)


def test_launch_counts_read_no_launch_on_a_cpu_vcycle():
    hier = amg.amg_setup(amg.aniso2d_9pt(N2),
                         amg.AMGParams(coarsening="pmis", theta=0.5),
                         device="cpu")
    r = torch.randn(N2 * N2, generator=torch.Generator().manual_seed(3))
    before = ops.launch_counts()
    z = amg.vcycle(hier, r)
    assert ops.launch_counts() == before        # the twins are no launch
    assert torch.isfinite(z).all() and float(z @ r) > 0


def _interior_strong_columns(theta: float) -> dict:
    """{row: sorted strong columns} of the level-0 strength mask on the
    interior rows of the 2D anisotropic operator."""
    a = amg.aniso2d_9pt(N2)
    col, val, _ = ell_planes_from_dia(a, dtype=np.float32)
    mask = hs.strength_mask_host(col, val, theta)
    out = {}
    for y in range(1, N2 - 1):
        for x in range(1, N2 - 1):
            i = y * N2 + x
            out[i] = sorted(int(c) for c in col[i][mask[i]])
    return out


def test_theta_half_keeps_exactly_the_y_couplings():
    for i, cols in _interior_strong_columns(0.5).items():
        assert cols == [i - N2, i + N2], i


def test_theta_quarter_admits_the_corners():
    for i, cols in _interior_strong_columns(0.25).items():
        want = sorted([i - N2 - 1, i - N2, i - N2 + 1,
                       i + N2 - 1, i + N2, i + N2 + 1])
        assert cols == want, i


def test_theta_half_certifies_in_a_third_of_the_iterations():
    a = amg.aniso2d_9pt(N2)
    b = amg.default_rhs(a, seed=0)
    iters = {}
    for theta in (0.5, 0.25):
        solver = amg.AMGSolver(a, amg.AMGParams(coarsening="pmis",
                                                theta=theta), device="cpu")
        x = solver.solve(b, tol=1e-8)
        info = solver.last_info
        assert info["rel_residual"] <= 1e-8
        true_rel = (np.linalg.norm(b.numpy() - amg.dia_to_scipy(a) @ x)
                    / np.linalg.norm(b.numpy()))
        assert true_rel <= 1e-8, theta
        iters[theta] = info["iters"]
    # the corners make θ = 0.25 coarsen along the weak x axis too, and its
    # V-cycle stops reducing the smooth-in-y error
    assert 3 * iters[0.5] <= iters[0.25], iters
