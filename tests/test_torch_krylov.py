"""The port's Krylov variants and the device certified loop, on the CPU:

- ``pcg_pipelined`` (single reduction) and ``cg`` (no preconditioner)
  against the reference's on the same operator and hierarchy setup: equal
  iteration counts, x within rtol 5e-3 / atol 5e-4; the pipelined count
  within one of standard PCG's;
- ``solve_ir_device`` (native f64 residuals on the hierarchy's device)
  against ``solve_ir`` (host f64 residuals): true residual ≤ 1e-10 at tol
  1e-11, its own residual within 2× of the true one, inner-count sums
  within 4;
- the facade's ``residual=`` and ``device_result=`` arguments.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omp_amg_tpu as ref
from omp_amg_tpu.amg.hierarchy import amg_setup as ref_setup
from omp_amg_tpu.amg.params import AMGParams as RefParams
from omp_amg_tpu.solvers.cg import amg_pcg as ref_amg_pcg
from omp_amg_tpu.solvers.cg import cg as ref_cg

import omp_amg_tpu_torch as port
from omp_amg_tpu_torch.native import CsrMatvec

torch.set_num_threads(2)

# generator, edge, grid (None: PMIS), parameters. The 3D structured case
# turns the ConstDia form off: the CPU reference does not fuse V(1,1)
CASES = {
    "7pt_16_structured": ("poisson3d_7pt", 16, (16,) * 3,
                          {"const_stencil": "off"}),
    "aniso9pt_32": ("aniso2d_9pt", 32, (32, 32), {}),
    "7pt_12_pmis": ("poisson3d_7pt", 12, None, {"coarsening": "pmis"}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pipelined_pcg_matches_reference(case):
    gen, n, grid, kw = CASES[case]
    a_j = getattr(ref, gen)(n)
    hier_j = ref_setup(getattr(ref, gen)(n, backend="numpy"), RefParams(**kw),
                       grid=grid)
    b = np.array(ref.default_rhs(a_j, "random", seed=0))
    a = getattr(port, gen)(n)
    hier = port.amg_setup(a, port.AMGParams(**kw), device="cpu", grid=grid)
    a_dev = hier.levels[0].a
    bt = torch.from_numpy(b)
    counts = {}
    for variant in ("standard", "pipelined"):
        want = ref_amg_pcg(a_j, jnp.asarray(b), hier_j, tol=1e-8,
                           maxiter=200, variant=variant)
        got = port.amg_pcg(a_dev, bt, hier, tol=1e-8, maxiter=200,
                           variant=variant)
        assert got.iters == int(want.iters), (variant, got.history)
        assert got.rel_residual <= 1e-8
        assert len(got.history) == got.iters + 1
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                                   rtol=5e-3, atol=5e-4)
        counts[variant] = got.iters
    assert 0 <= counts["pipelined"] - counts["standard"] <= 1, counts
    direct = port.pcg_pipelined(a_dev, bt, lambda r: port.vcycle(hier, r),
                                tol=1e-8, maxiter=200)
    assert direct.iters == counts["pipelined"]


def test_cg_matches_reference():
    a_j = ref.poisson3d_7pt(12)
    b = np.array(ref.default_rhs(a_j, "random", seed=0))
    want = ref_cg(a_j, jnp.asarray(b), tol=1e-6, maxiter=300)
    a = port.poisson3d_7pt(12)
    a_dev = port.amg_setup(a, port.AMGParams(coarsening="pmis"),
                           device="cpu").levels[0].a
    got = port.cg(a_dev, torch.from_numpy(b), tol=1e-6, maxiter=300)
    assert got.iters == int(want.iters), (got.iters, int(want.iters))
    assert got.rel_residual <= 1e-6
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=5e-3,
                               atol=5e-4)


@pytest.mark.parametrize("gen,n,grid", [("poisson3d_7pt", 20, (20,) * 3),
                                        ("aniso2d_9pt", 48, (48, 48))])
def test_solve_ir_device_matches_host_loop(gen, n, grid):
    a = getattr(port, gen)(n)
    hier = port.amg_setup(a, port.AMGParams(), device="cpu", grid=grid)
    b = port.default_rhs(a, seed=0).numpy().astype(np.float64)
    sp = port.dia_to_scipy(a)
    res_d = port.solve_ir_device(a, b, hier, tol=1e-11)
    res_h = port.solve_ir(CsrMatvec(sp.indptr, sp.indices, sp.data,
                                    n_cols=sp.shape[1]),
                          b, hier.levels[0].a, hier, tol=1e-11)
    assert isinstance(res_d.x, np.ndarray) and res_d.x.dtype == np.float64
    true_rel = np.linalg.norm(b - sp @ res_d.x) / np.linalg.norm(b)
    assert true_rel < 1e-10, true_rel
    assert res_d.rel_residual <= max(2 * true_rel, 5e-13)
    assert true_rel <= max(2 * res_d.rel_residual, 5e-13)
    assert abs(sum(res_d.inner_iters) - sum(res_h.inner_iters)) <= 4
    assert res_d.outer_iters == len(res_d.inner_iters)
    # the device result: the same f64 x, left on the device
    res_t = port.solve_ir_device(a, b, hier, tol=1e-11, to_host=False)
    assert isinstance(res_t.x, torch.Tensor)
    assert res_t.x.dtype == torch.float64
    assert res_t.inner_iters == res_d.inner_iters
    np.testing.assert_array_equal(res_t.x.numpy(), res_d.x)


def test_solve_ir_device_needs_a_dia():
    a = port.poisson3d_7pt(8)
    hier = port.amg_setup(a, port.AMGParams(coarsening="pmis"), device="cpu")
    with pytest.raises(TypeError):
        port.solve_ir_device(port.dia_to_scipy(a), np.ones(a.n_rows), hier)


@pytest.mark.parametrize("grid", [(16,) * 3, None])
def test_facade_residual_modes(grid):
    a = port.poisson3d_7pt(16)
    b = port.default_rhs(a, seed=0)
    solver = port.AMGSolver(a, port.AMGParams(), grid=grid, device="cpu")
    x_h = solver.solve(b, tol=1e-10)       # "auto" on the CPU: the host loop
    host = solver.last_info
    assert host["residual"] == "host"
    x_d = solver.solve(b, tol=1e-10, residual="device")
    dev = solver.last_info
    assert dev["residual"] == "device" and dev["certified_f64"]
    assert dev["rel_residual"] <= 1e-10
    assert dev["inner_iters"] == host["inner_iters"]
    assert dev["outer_iters"] == host["outer_iters"]
    b64 = b.numpy().astype(np.float64)
    true_rel = (np.linalg.norm(b64 - port.dia_to_scipy(a) @ x_d)
                / np.linalg.norm(b64))
    assert true_rel <= 1e-10
    np.testing.assert_allclose(x_d, x_h, rtol=1e-8, atol=1e-12)
    xt = solver.solve(b, tol=1e-10, residual="device", device_result=True)
    assert isinstance(xt, torch.Tensor) and xt.dtype == torch.float64
    assert xt.device == solver.device
    np.testing.assert_array_equal(xt.numpy(), x_d)
    solver.solve(b, tol=1e-10, residual="device", variant="pipelined")
    pip = solver.last_info
    assert all(0 <= p - s <= 1 for p, s in zip(pip["inner_iters"],
                                                 dev["inner_iters"]))
    with pytest.raises(ValueError):
        solver.solve(b, device_result=True)      # the host loop
    with pytest.raises(ValueError):
        solver.solve(b, residual="gpu")
    with pytest.raises(ValueError):
        solver.solve(b, variant="fused")
