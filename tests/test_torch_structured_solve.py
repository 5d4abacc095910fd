"""The port's structured solve path against the reference's, on the CPU:

- one V-cycle of the port on a structured hierarchy carried over from the
  reference (``hierarchy_from_numpy``) against the reference's ``vcycle`` on
  the same b: max|Δ| ≤ 1e-5·max|ref|. The port runs the fused ConstDia
  V(1,1) pair on level 0; the CPU reference runs it unfused;
- the certified ``AMGSolver(a, params, grid=dims).solve(b, tol=1e-8)``: both
  reach a true f64 relative residual ≤ 1e-8, and
  - with ``const_stencil="off"`` (every level ``Dia``, unfused in both
    packages), and on the 2D configurations (which have no ``ConstDia``),
    the inner iterations per outer pass and the outer count are equal;
  - with the default ``const_stencil="auto"``, where the port fuses V(1,1)
    and the CPU reference does not, the outer count is equal and each inner
    count is within 1 (the fused pre-smooth reassociates s·Σc·b against
    Σc·(s·b)); a difference prints both residual histories.
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
from omp_amg_tpu.solvers.cg import amg_pcg as ref_amg_pcg
from omp_amg_tpu.solvers.ir import solve_ir as ref_solve_ir

import omp_amg_tpu_torch as port

torch.set_num_threads(2)

CONFIGS = {
    "7pt_16": ("poisson3d_7pt", (16,), (16, 16, 16)),
    "7pt_32": ("poisson3d_7pt", (32,), (32, 32, 32)),
    "5pt_64": ("poisson2d_5pt", (64,), (64, 64)),
    "aniso9pt_64": ("aniso2d_9pt", (64,), (64, 64)),
}


def _operators(name):
    gen, args, dims = CONFIGS[name]
    return (getattr(ref, gen)(*args, backend="numpy"),
            getattr(port, gen)(*args), dims)


def _hierarchy_to_numpy(hier):
    levels = []
    for lv in hier.levels:
        d = {"dinv": np.asarray(lv.dinv), "lmax": float(np.asarray(lv.lmax)),
             "grid": (lv.p.fine_shape, lv.p.coarse_shape, lv.p.coarsened)}
        if isinstance(lv.a, ref.ConstDia):
            d["a_const"] = {"coeffs": lv.a.coeffs, "taps": lv.a.taps,
                            "offsets": lv.a.offsets, "dims": lv.a.dims}
        else:
            d.update(a_data=np.asarray(lv.a.data), a_offsets=lv.a.offsets,
                     a_dims=lv.a.dims)
        levels.append(d)
    return levels, np.asarray(hier.coarse_chol)


@pytest.mark.parametrize("name,sweeps", [("7pt_16", 1), ("7pt_32", 1),
                                         ("5pt_64", 1), ("7pt_16", 2)])
def test_vcycle_matches_reference(name, sweeps):
    # V(2,2) on a ConstDia level runs the unfused sweeps with a scalar s
    a_j, _, dims = _operators(name)
    hier_j = ref_setup(a_j, RefParams(nu_pre=sweeps, nu_post=sweeps),
                       grid=dims)
    levels, chol = _hierarchy_to_numpy(hier_j)
    hier_t = port.hierarchy_from_numpy(levels, chol, hier_j.params,
                                       device="cpu")
    assert hier_t.n_levels == hier_j.n_levels
    assert ([type(lv.a).__name__ for lv in hier_t.levels]
            == [type(lv.a).__name__ for lv in hier_j.levels])
    n = a_j.n_rows
    b = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    want = np.asarray(jax.jit(ref_vcycle)(hier_j, jnp.asarray(b)),
                      np.float64)
    got = port.vcycle(hier_t, torch.from_numpy(b)).numpy().astype(np.float64)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (err, np.abs(want).max())


def _reference_solve(a_j, dims, params, b):
    """The reference's certified solve, and the residual history of its
    first outer pass (its IR keeps none: the pass is replayed, from
    b/‖b‖ at inner tolerance 1e-6, as solve_ir runs it)."""
    solver = ref.AMGSolver(a_j, params, grid=dims)
    res = ref_solve_ir(solver.a_host, b, solver.a, solver.hierarchy,
                       tol=1e-8, maxiter=500)
    cg = ref_amg_pcg(solver.a,
                     jnp.asarray(b / np.linalg.norm(b), jnp.float32),
                     solver.hierarchy, tol=1e-6, maxiter=500)
    hist = np.asarray(cg.history)
    return res, hist[np.isfinite(hist)].tolist()


def _solve_pair(name, const_stencil):
    a_j, a_t, dims = _operators(name)
    b_t = port.default_rhs(a_t, seed=0)
    b = b_t.numpy().astype(np.float64)
    res_j, hist_j = _reference_solve(
        a_j, dims, RefParams(const_stencil=const_stencil), b)
    solver = port.AMGSolver(a_t, port.AMGParams(const_stencil=const_stencil),
                            grid=dims, device="cpu")
    x = solver.solve(b_t, tol=1e-8)
    info = solver.last_info
    assert info["rel_residual"] <= 1e-8
    assert res_j.rel_residual <= 1e-8
    true_rel = (np.linalg.norm(b - port.dia_to_scipy(a_t) @ x)
                / np.linalg.norm(b))
    assert true_rel <= 1e-8
    return res_j, hist_j, info


@pytest.mark.parametrize("name", ["7pt_16", "7pt_32", "5pt_64",
                                  "aniso9pt_64"])
def test_certified_solve_counts_equal_reference(name):
    # 3D with every level Dia and unfused; 2D has no ConstDia level anyway
    cs = "off" if name.startswith("7pt") else "auto"
    res_j, _, info = _solve_pair(name, cs)
    assert info["inner_iters"] == list(res_j.inner_iters)
    assert info["outer_iters"] == res_j.outer_iters


@pytest.mark.parametrize("name", ["7pt_16", "7pt_32"])
def test_certified_solve_fused_counts_within_one(name):
    res_j, hist_j, info = _solve_pair(name, "auto")
    assert info["outer_iters"] == res_j.outer_iters
    diffs = [abs(a - b) for a, b in zip(info["inner_iters"],
                                         res_j.inner_iters)]
    if any(diffs):
        print(f"{name}: port inner {info['inner_iters']}, reference inner "
              f"{list(res_j.inner_iters)}")
        print("reference history outer=0: "
              + " ".join(f"{v:.6e}" for v in hist_j))
        for k, h in enumerate(info["residual_histories"]):
            print(f"port history outer={k}: "
                  + " ".join(f"{v:.6e}" for v in h))
    assert max(diffs, default=0) <= 1


def test_structured_solver_options():
    a = port.poisson3d_7pt(8)
    with pytest.raises(ValueError):
        port.AMGSolver(a, port.AMGParams(), grid=(8, 8, 8), refreshable=True)
    solver = port.AMGSolver(a, port.AMGParams(), grid=(8, 8, 8),
                            device="cpu")
    # an 8×8 plane fails the 128-lane rule, so level 0 stays banded
    assert isinstance(solver.a_dev, port.Dia)
    z = solver.precondition(port.default_rhs(a, seed=1))
    assert z.shape == (a.n_rows,) and torch.isfinite(z).all()
