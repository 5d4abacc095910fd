"""The port's smoother, cycle and coarse-solve options against the
reference's, on the CPU:

- one preconditioner application per smoother × cycle × coarse solver on a
  hierarchy carried over from the reference (``hierarchy_from_numpy``),
  structured 3D 16³ (the port fuses Jacobi V(1,1) on its ``ConstDia`` level,
  the CPU reference does not) and PMIS 12³: max|Δ| ≤ 1e-5·max|ref| against
  the reference's ``vcycle``;
- ⟨u, M v⟩ = ⟨M u, v⟩ to 1e-4 with the ``inv`` coarse solve;
- the certified ``AMGSolver.solve(b, tol=1e-8)`` on structured 3D 16³ for
  each option: the reference's inner counts per outer pass and outer count,
  a true f64 residual ≤ 1e-8.
"""

import dataclasses
import functools

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

SMOOTHERS = ("jacobi", "l1jacobi", "chebyshev")
CYCLES = ("v", "w", "f")
COARSE = ("chol", "inv")
PIPELINES = {
    # name: (generator, edge, setup parameters, grid)
    "structured_16": ("poisson3d_7pt", 16, {"coarse_size": 60}, (16,) * 3),
    "pmis_12": ("poisson3d_7pt", 12, {"coarsening": "pmis"}, None),
}


def _hierarchy_to_numpy(hier):
    """The reference's hierarchy as ``hierarchy_from_numpy``'s dicts."""
    levels = []
    for lv in hier.levels:
        d = {"dinv": np.asarray(lv.dinv), "lmax": float(np.asarray(lv.lmax))}
        a = lv.a
        if isinstance(a, ref.ConstDia):
            d["a_const"] = {"coeffs": a.coeffs, "taps": a.taps,
                            "offsets": a.offsets, "dims": a.dims}
        elif isinstance(a, ref.Dia):
            d.update(a_data=np.asarray(a.data), a_offsets=a.offsets,
                     a_dims=a.dims)
        else:
            d.update(a_col=np.asarray(a.col), a_val=np.asarray(a.val),
                     a_n_cols=a.n_cols)
        if hasattr(lv.p, "fine_shape"):
            d["grid"] = (lv.p.fine_shape, lv.p.coarse_shape, lv.p.coarsened)
        else:
            for name in ("p", "r"):
                op = getattr(lv, name)
                d.update({f"{name}_col": np.asarray(op.col),
                          f"{name}_val": np.asarray(op.val),
                          f"{name}_n_cols": op.n_cols})
        levels.append(d)
    return levels, np.asarray(hier.coarse_chol)


@functools.lru_cache(maxsize=None)
def _ref_hierarchy(pipeline, smoother, coarse):
    """The reference's setup (the cycle type does not enter it)."""
    gen, n, kw, grid = PIPELINES[pipeline]
    a = getattr(ref, gen)(n, backend="numpy")
    return ref_setup(a, RefParams(smoother=smoother, coarse_solver=coarse,
                                  **kw), grid=grid)


# every combination on the structured hierarchy; on the PMIS one each
# option once (its W cycle unrolls more levels in the reference's trace)
CASES = ([("structured_16", sm, cy, co) for sm in SMOOTHERS for cy in CYCLES
          for co in COARSE]
         + [("pmis_12", "chebyshev", "v", "chol"),
            ("pmis_12", "l1jacobi", "v", "chol"),
            ("pmis_12", "jacobi", "w", "chol"),
            ("pmis_12", "chebyshev", "f", "chol"),
            ("pmis_12", "jacobi", "v", "inv"),
            ("pmis_12", "l1jacobi", "w", "inv")])


@pytest.mark.parametrize("pipeline,smoother,cycle,coarse", CASES)
def test_preconditioner_matches_reference(pipeline, smoother, cycle, coarse):
    hier_j = _ref_hierarchy(pipeline, smoother, coarse)
    hier_j = dataclasses.replace(
        hier_j, params=dataclasses.replace(hier_j.params, cycle=cycle))
    levels, chol = _hierarchy_to_numpy(hier_j)
    hier_t = port.hierarchy_from_numpy(levels, chol, hier_j.params,
                                       device="cpu")
    assert hier_t.n_levels == hier_j.n_levels
    n = hier_t.levels[0].a.n_rows
    b = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    want = np.asarray(jax.jit(ref_vcycle)(hier_j, jnp.asarray(b)),
                      np.float64)
    got = port.vcycle(hier_t, torch.from_numpy(b)).numpy().astype(np.float64)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("grid", [(14,) * 3, None])
def test_inv_coarse_solve_keeps_the_cycle_symmetric(grid):
    a = port.poisson3d_7pt(14)
    hier = port.amg_setup(a, port.AMGParams(coarse_size=400,
                                            coarse_solver="inv"),
                          device="cpu", grid=grid)
    assert hier.coarse_chol.shape[0] <= 400
    torch.testing.assert_close(hier.coarse_chol, hier.coarse_chol.T,
                               rtol=0, atol=0)
    rng = np.random.default_rng(7)
    u, v = (torch.from_numpy(rng.standard_normal(a.n_rows).astype(np.float32))
            for _ in range(2))
    lhs = float(torch.dot(u, port.vcycle(hier, v)))
    rhs = float(torch.dot(port.vcycle(hier, u), v))
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), abs(rhs))


OPTIONS = {
    "chebyshev": {"smoother": "chebyshev"},
    "l1jacobi": {"smoother": "l1jacobi"},
    "w": {"cycle": "w"},
    "f": {"cycle": "f"},
    "inv": {"coarse_solver": "inv", "coarse_size": 400},
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_certified_counts_equal_reference(option):
    kw = OPTIONS[option]
    dims = (16,) * 3
    a_j = ref.poisson3d_7pt(16, backend="numpy")
    b = np.asarray(ref.default_rhs(ref.poisson3d_7pt(16), seed=0),
                   np.float64)
    solver_j = ref.AMGSolver(a_j, RefParams(**kw), grid=dims)
    res_j = ref_solve_ir(solver_j.a_host, b, solver_j.a, solver_j.hierarchy,
                         tol=1e-8, maxiter=500)

    a = port.poisson3d_7pt(16)
    solver = port.AMGSolver(a, port.AMGParams(**kw), grid=dims,
                            device="cpu")
    x = solver.solve(port.default_rhs(a, seed=0), tol=1e-8)
    info = solver.last_info
    assert info["inner_iters"] == res_j.inner_iters, (
        info["residual_histories"])
    assert info["outer_iters"] == res_j.outer_iters
    assert info["rel_residual"] <= 1e-8 and res_j.rel_residual <= 1e-8
    true_rel = (np.linalg.norm(b - port.dia_to_scipy(a) @ x)
                / np.linalg.norm(b))
    assert true_rel <= 1e-8
