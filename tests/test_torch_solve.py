"""The port's solve path against the reference's, on the CPU:

- one V-cycle of the port on a hierarchy carried over from the reference
  (``hierarchy_from_numpy``) against the reference's ``vcycle`` on the same
  b: max|Δ| ≤ 1e-5·max|ref| (f32 sums in another order);
- the certified ``AMGSolver.solve(b, tol=1e-8)`` at 16³ and 24³, and on
  ``bench.py``'s PMIS configs at CPU sizes (2d5pt 32², aniso9pt 32² at
  θ = 0.5, 27pt 12³): the same inner iteration counts per outer pass and
  the same outer count as the reference, with a true f64 relative residual
  ≤ 1e-8; also bench.py's fourth config, 27pt with the Chebyshev smoother
  (12³ here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omp_amg_tpu as ref
from omp_amg_tpu.amg.hierarchy import amg_setup as ref_setup
from omp_amg_tpu.amg.params import AMGParams as RefParams
from omp_amg_tpu.amg.vcycle import vcycle as ref_vcycle
from omp_amg_tpu.solvers.ir import solve_ir as ref_solve_ir

import omp_amg_tpu_torch as port

torch.set_num_threads(2)


def _hierarchy_to_numpy(hier):
    levels = []
    for lv in hier.levels:
        d = {"dinv": np.asarray(lv.dinv), "lmax": float(np.asarray(lv.lmax))}
        if isinstance(lv.a, ref.Dia):
            d.update(a_data=np.asarray(lv.a.data), a_offsets=lv.a.offsets)
        else:
            d.update(a_col=np.asarray(lv.a.col), a_val=np.asarray(lv.a.val),
                     a_n_cols=lv.a.n_cols)
        for name in ("p", "r"):
            op = getattr(lv, name)
            d.update({f"{name}_col": np.asarray(op.col),
                      f"{name}_val": np.asarray(op.val),
                      f"{name}_n_cols": op.n_cols})
        levels.append(d)
    return levels, np.asarray(hier.coarse_chol)


@pytest.mark.parametrize("n", [16, 24])
def test_vcycle_matches_reference(n):
    hier_j = ref_setup(ref.poisson3d_7pt(n, backend="numpy"),
                       RefParams(coarsening="pmis"))
    levels, chol = _hierarchy_to_numpy(hier_j)
    hier_t = port.hierarchy_from_numpy(levels, chol, hier_j.params,
                                       device="cpu")
    assert hier_t.n_levels == hier_j.n_levels
    b = np.random.default_rng(3).standard_normal(n ** 3).astype(np.float32)
    want = np.asarray(jax.jit(ref_vcycle)(hier_j, jnp.asarray(b)),
                      np.float64)
    got = port.vcycle(hier_t, torch.from_numpy(b)).numpy().astype(np.float64)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("n", [16, 24])
def test_certified_solve_matches_reference(n):
    a_j = ref.poisson3d_7pt(n, backend="numpy")
    b = np.asarray(ref.default_rhs(ref.poisson3d_7pt(n), seed=0),
                   np.float64)
    solver_j = ref.AMGSolver(a_j, RefParams(coarsening="pmis"))
    solver_j.solve(b, tol=1e-8)
    res_j = ref_solve_ir(solver_j.a_host, b, solver_j.a, solver_j.hierarchy,
                         tol=1e-8, maxiter=500)

    a = port.poisson3d_7pt(n)
    b_t = port.default_rhs(a, seed=0)
    np.testing.assert_array_equal(b_t.numpy().astype(np.float64), b)
    solver = port.AMGSolver(a, port.AMGParams(coarsening="pmis"),
                            device="cpu")
    x = solver.solve(b_t, tol=1e-8)
    info = solver.last_info

    assert info["iters"] == solver_j.last_info["iters"]
    assert info["outer_iters"] == solver_j.last_info["outer_iters"]
    assert info["inner_iters"] == res_j.inner_iters
    assert info["rel_residual"] <= 1e-8
    assert solver_j.last_info["rel_residual"] <= 1e-8
    true_rel = (np.linalg.norm(b - port.dia_to_scipy(a) @ x)
                / np.linalg.norm(b))
    assert true_rel <= 1e-8


# bench.py's pmis_configs (bench.py:383-475) at CPU sizes: the generator, its
# size, and the PMIS parameters bench.py gives it (θ = 0.5 for the
# anisotropic 9-point operator)
BENCH_CONFIGS = {
    "2d5pt_32": ("poisson2d_5pt", 32, {}),
    "aniso9pt_32_theta0.5": ("aniso2d_9pt", 32, {"theta": 0.5}),
    "27pt_12": ("poisson3d_27pt", 12, {}),
    "27pt_12_cheby": ("poisson3d_27pt", 12, {"smoother": "chebyshev"}),
}


@pytest.mark.parametrize("config", list(BENCH_CONFIGS))
def test_certified_solve_matches_reference_on_bench_configs(config):
    """The certified PMIS solve of bench.py's configs: the reference's inner
    counts per outer pass and outer count, true f64 residual ≤ 1e-8."""
    gen, n, kw = BENCH_CONFIGS[config]
    a_j = getattr(ref, gen)(n, backend="numpy")
    b = np.asarray(ref.default_rhs(getattr(ref, gen)(n), seed=0), np.float64)
    solver_j = ref.AMGSolver(a_j, RefParams(coarsening="pmis", **kw))
    solver_j.solve(b, tol=1e-8)
    res_j = ref_solve_ir(solver_j.a_host, b, solver_j.a, solver_j.hierarchy,
                         tol=1e-8, maxiter=500)

    a = getattr(port, gen)(n)
    b_t = port.default_rhs(a, seed=0)
    np.testing.assert_array_equal(b_t.numpy().astype(np.float64), b)
    solver = port.AMGSolver(a, port.AMGParams(coarsening="pmis", **kw),
                            device="cpu")
    x = solver.solve(b_t, tol=1e-8)
    info = solver.last_info

    assert info["inner_iters"] == res_j.inner_iters
    assert info["outer_iters"] == solver_j.last_info["outer_iters"]
    assert info["rel_residual"] <= 1e-8
    true_rel = (np.linalg.norm(b - port.dia_to_scipy(a) @ x)
                / np.linalg.norm(b))
    assert true_rel <= 1e-8


def test_uncertified_solve_and_precondition():
    a = port.poisson3d_7pt(12)
    solver = port.AMGSolver(a, port.AMGParams(coarsening="pmis"),
                            device="cpu")
    b = port.default_rhs(a, seed=1)
    x = solver.solve(b, tol=1e-5, certify=False)
    assert isinstance(x, torch.Tensor) and x.dtype == torch.float32
    assert not solver.last_info["certified_f64"]
    r = b.numpy() - port.dia_to_scipy(a) @ x.numpy()
    assert np.linalg.norm(r) <= 1e-4 * np.linalg.norm(b.numpy())
    z = solver.precondition(b)
    assert z.shape == b.shape and torch.isfinite(z).all()


def test_solver_raises_on_unported_options(monkeypatch):
    a = port.poisson3d_7pt(8)
    p = port.AMGParams(coarsening="pmis")
    for kw in (dict(mesh=object()), dict(flavor="device"),
               dict(refreshable=True)):
        with pytest.raises(NotImplementedError):
            port.AMGSolver(a, p, **kw)
    # structured hierarchies do not refresh: refused at construction
    with pytest.raises(ValueError):
        port.AMGSolver(a, port.AMGParams(), grid=(8, 8, 8), refreshable=True)
    # every smoother of the reference is ported; a value outside them is not
    with pytest.raises(NotImplementedError):
        port.AMGSolver(a, port.AMGParams(smoother="gauss-seidel"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        port.AMGSolver(a, p, device="cuda")


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a device argument the entry points run on the card; without
    CUDA they raise, naming it, instead of moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = port.poisson3d_7pt(8)
    p = port.AMGParams(coarsening="pmis")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.AMGSolver(a, p)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.amg_setup(a, p)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.amg_setup(a, port.AMGParams(), grid=(8, 8, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        port.hierarchy_from_numpy([], np.ones((1, 1)), p)
