"""The port's distributed structured solve against the reference's, on the
CPU (the reference on the 8 virtual CPU devices):

- one sharded V-cycle of the port on the reference's per-shard hierarchy,
  carried over by ``dist_hierarchy_from_numpy``, within 1e-5·max|ref| of
  the reference's ``make_dist_vcycle``;
- ``make_dist_solver`` (f32 sharded AMG-PCG, tol 1e-6) on each package's
  own per-shard setup of the 7-point 16³ problem: equal iteration counts at
  d ∈ {2, 8}, on both halo transports (the reference's Pallas transport in
  interpret mode);
- the certified facade, ``AMGSolver(..., mesh=ShardMesh(4))``, at 16³: a
  true f64 relative residual ≤ 1e-8 (≤ 2e-8 re-checked with scipy), and the
  inner count of each outer pass and the outer count equal to the
  reference's distributed certified solve (df64 residuals there, native f64
  here);
- the options: one sharded cycle with Chebyshev, l1-Jacobi, the W and F
  cycles and the ``inv`` coarse solve on the reference's hierarchy
  (1e-5·max|ref|), and ``make_dist_solver`` with Chebyshev, l1-Jacobi, the
  W cycle and the pipelined PCG on each package's own per-shard setup:
  equal iteration counts; the pipelined count within one of standard's;
- the facade's refusals with a mesh (the device-flavor setup; a refresh
  with ``grid=``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omp_amg_tpu as ref
from omp_amg_tpu.amg.params import AMGParams as RefParams
from omp_amg_tpu.parallel.dist import (
    AXIS, make_dist_solver as ref_make_dist_solver,
    make_dist_vcycle as ref_make_dist_vcycle,
)
from omp_amg_tpu.parallel.dist_ir import (
    make_dist_ir_solver as ref_make_dist_ir_solver,
)
from omp_amg_tpu.parallel.dist_setup import (
    dist_structured_setup as ref_dist_setup,
)
from omp_amg_tpu.parallel.partition import pad_vector as ref_pad_vector
from omp_amg_tpu.sparse.formats import (
    ConstDia as RefConstDia, PlaneDia, const_to_dia, plane_to_dia,
)

import omp_amg_tpu_torch as port
from omp_amg_tpu_torch.parallel.dist import (
    make_dist_solver, make_dist_vcycle,
)
from omp_amg_tpu_torch.parallel.dist_setup import dist_structured_setup

torch.set_num_threads(2)

DIMS = (16, 16, 16)


def _ref_mesh(d):
    return jax.make_mesh((d,), (AXIS,))


def _dist_to_numpy(dh):
    levels = []
    for lv in dh.levels:
        a, p = lv.a, lv.p
        out = {"sharded": lv.sharded, "dinv": np.asarray(lv.dinv),
               "lmax": float(lv.lmax), "n_next": lv.n_next,
               "grid": (p.fine_shape, p.coarse_shape, p.coarsened)}
        if lv.sharded:
            out.update(hl=a.hl, hr=a.hr, slice_in=p.slice_in,
                       gather_out=lv.r.gather_out)
        else:
            if isinstance(a, RefConstDia):
                a = const_to_dia(a)
            if isinstance(a, PlaneDia):
                a = plane_to_dia(a)
        out.update(a_data=np.asarray(a.data), a_offsets=a.offsets,
                   a_dims=a.dims)
        levels.append(out)
    return levels, np.asarray(dh.coarse_chol)


def _rhs(n_rows):
    return np.random.default_rng(7).standard_normal(n_rows).astype(np.float32)


@pytest.mark.parametrize("transport", ["ppermute", "remote"])
def test_vcycle_on_reference_hierarchy(transport):
    a_j = ref.poisson3d_7pt(16)
    mesh_j = _ref_mesh(4)
    dh_j = ref_dist_setup(a_j, DIMS, mesh_j, RefParams(coarse_size=60),
                          agg_rows_per_dev=32)
    levels, chol = _dist_to_numpy(dh_j)
    mesh = port.ShardMesh(4, "cpu")
    dh = port.dist_hierarchy_from_numpy(levels, chol, dh_j.params, mesh,
                                        transport=transport)
    assert [lv.sharded for lv in dh.levels] == [True, True, False]
    b = _rhs(a_j.n_rows)
    want = np.asarray(ref_make_dist_vcycle(mesh_j, dh_j)(dh_j,
                                                         jnp.asarray(b)))
    got = make_dist_vcycle(mesh, dh)(dh, torch.from_numpy(b)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("d", [2, 8])
@pytest.mark.parametrize("transport", ["ppermute", "remote"])
def test_dist_solver_counts_equal_reference(d, transport):
    a_j = ref.poisson3d_7pt(16)
    mesh_j = _ref_mesh(d)
    dh_j = ref_dist_setup(a_j, DIMS, mesh_j, RefParams(coarse_size=60),
                          agg_rows_per_dev=32,
                          transport="pallas" if transport == "remote"
                          else transport)
    b = _rhs(a_j.n_rows)
    _, iters_j, rel_j = ref_make_dist_solver(mesh_j, dh_j, tol=1e-6,
                                             maxiter=100)(
        dh_j, jnp.asarray(b))
    mesh = port.ShardMesh(d, "cpu")
    dh = dist_structured_setup(port.poisson3d_7pt(16), DIMS, mesh,
                               port.AMGParams(coarse_size=60),
                               agg_rows_per_dev=32, transport=transport)
    assert dh.levels[0].a.transport == transport
    res = make_dist_solver(mesh, dh, tol=1e-6, maxiter=100)(
        dh, torch.from_numpy(b))
    assert res.x.shape == (a_j.n_rows,)
    assert res.iters == int(iters_j)
    assert res.rel_residual <= 1e-6


def test_certified_facade_counts_equal_reference():
    a_j = ref.poisson3d_7pt(16)
    a = port.poisson3d_7pt(16)
    b_t = port.default_rhs(a, seed=0)
    b64 = b_t.numpy().astype(np.float64)
    mesh_j = _ref_mesh(4)
    solver_j = ref.AMGSolver(a_j, RefParams(), grid=DIMS, mesh=mesh_j,
                             agg_rows_per_dev=64)
    # the facade's own certified call, keeping its per-outer inner counts
    res_j = ref_make_dist_ir_solver(mesh_j, solver_j.hierarchy, tol=1e-8,
                                    maxiter=500)(
        solver_j.hierarchy, ref_pad_vector(b64, solver_j.hierarchy, 4))
    solver = port.AMGSolver(a, port.AMGParams(), grid=DIMS,
                            mesh=port.ShardMesh(4, "cpu"), device="cpu",
                            agg_rows_per_dev=64)
    assert solver.stats()["sharded"] == [True, True]   # 4³ coarse: dense
    x = solver.solve(b_t, tol=1e-8)
    info = solver.last_info
    assert info["certified_f64"] and info["distributed"]
    assert info["residual"] == "device"
    assert info["rel_residual"] <= 1e-8 and res_j.rel_residual <= 1e-8
    true_rel = (np.linalg.norm(b64 - port.dia_to_scipy(a) @ x)
                / np.linalg.norm(b64))
    assert true_rel <= 2e-8
    assert info["inner_iters"] == list(res_j.inner_iters)
    assert info["outer_iters"] == res_j.outer_iters
    # the uncertified f32 solve and one preconditioner application
    x32 = solver.solve(b_t, tol=1e-6, certify=False)
    assert x32.shape == (a.n_rows,) and solver.last_info["rel_residual"] \
        <= 1e-6
    z = solver.precondition(b_t)
    assert z.shape == (a.n_rows,) and torch.isfinite(z).all()
    # the sharded certified loop forms its residual on the device and
    # returns x on the host
    for kw in (dict(residual="host"), dict(device_result=True)):
        with pytest.raises(ValueError):
            solver.solve(b_t, **kw)


@pytest.mark.parametrize("d", [1, 4])
def test_partitioned_central_hierarchy_matches_serial(d):
    """The central setup partitioned into z-slabs (the facade's fallback
    when the per-shard setup raises; at d = 1 it does, since no block
    reaches ``agg_rows_per_dev``) solves in the serial solve's count: the
    same operators, the ConstDia fine level materialized and unfused."""
    from omp_amg_tpu_torch.parallel.partition import (
        partition_hierarchy, place_hierarchy,
    )

    a = port.poisson3d_7pt(16)
    b = port.default_rhs(a, seed=0)
    params = port.AMGParams(coarse_size=60)
    hs = port.amg_setup(a, port.AMGParams(coarse_size=60,
                                          const_stencil="off"),
                        device="cpu", grid=DIMS)
    serial = port.amg_pcg(hs.levels[0].a, b, hs, tol=1e-6, maxiter=100)
    mesh = port.ShardMesh(d, "cpu")
    if d == 1:
        solver = port.AMGSolver(a, params, grid=DIMS, mesh=mesh,
                                device="cpu", agg_rows_per_dev=1 << 20)
        dh = solver.hierarchy
    else:
        hier = port.amg_setup(a, params, device="cpu", grid=DIMS)
        dh = place_hierarchy(partition_hierarchy(hier, d,
                                                 agg_rows_per_dev=64), mesh)
    assert dh.levels[0].sharded and dh.nshards == d
    res = make_dist_solver(mesh, dh, tol=1e-6, maxiter=100)(dh, b)
    assert res.iters == serial.iters
    assert (res.x - serial.x).abs().max() <= 1e-4 * serial.x.abs().max()


CYCLE_OPTIONS = {
    "l1jacobi_w": {"smoother": "l1jacobi", "cycle": "w"},
    "chebyshev_f_inv": {"smoother": "chebyshev", "cycle": "f",
                        "coarse_solver": "inv"},
}


@pytest.mark.parametrize("option", list(CYCLE_OPTIONS))
def test_option_cycle_on_reference_hierarchy(option):
    a_j = ref.poisson3d_7pt(16)
    mesh_j = _ref_mesh(4)
    dh_j = ref_dist_setup(a_j, DIMS, mesh_j,
                          RefParams(coarse_size=60, **CYCLE_OPTIONS[option]),
                          agg_rows_per_dev=32)
    levels, chol = _dist_to_numpy(dh_j)
    mesh = port.ShardMesh(4, "cpu")
    dh = port.dist_hierarchy_from_numpy(levels, chol, dh_j.params, mesh,
                                        transport="remote")
    b = _rhs(a_j.n_rows)
    want = np.asarray(ref_make_dist_vcycle(mesh_j, dh_j)(dh_j,
                                                         jnp.asarray(b)))
    got = make_dist_vcycle(mesh, dh)(dh, torch.from_numpy(b)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


SOLVE_OPTIONS = {
    "chebyshev": ({"smoother": "chebyshev"}, "standard"),
    "l1jacobi": ({"smoother": "l1jacobi"}, "standard"),
    "w": ({"cycle": "w"}, "standard"),
    "pipelined": ({}, "pipelined"),
}


@pytest.mark.parametrize("option", list(SOLVE_OPTIONS))
def test_dist_solver_options_count_equal_reference(option):
    kw, variant = SOLVE_OPTIONS[option]
    a_j = ref.poisson3d_7pt(16)
    mesh_j = _ref_mesh(4)
    dh_j = ref_dist_setup(a_j, DIMS, mesh_j, RefParams(coarse_size=60, **kw),
                          agg_rows_per_dev=32)
    b = _rhs(a_j.n_rows)
    _, iters_j, _ = ref_make_dist_solver(mesh_j, dh_j, tol=1e-6, maxiter=100,
                                         variant=variant)(
        dh_j, jnp.asarray(b))
    mesh = port.ShardMesh(4, "cpu")
    dh = dist_structured_setup(port.poisson3d_7pt(16), DIMS, mesh,
                               port.AMGParams(coarse_size=60, **kw),
                               agg_rows_per_dev=32, transport="remote")
    res = make_dist_solver(mesh, dh, tol=1e-6, maxiter=100,
                           variant=variant)(dh, torch.from_numpy(b))
    assert res.iters == int(iters_j), (res.iters, int(iters_j))
    assert res.rel_residual <= 1e-6
    assert len(res.history) == res.iters + 1
    if variant == "pipelined":
        std = make_dist_solver(mesh, dh, tol=1e-6, maxiter=100)(
            dh, torch.from_numpy(b))
        assert 0 <= res.iters - std.iters <= 1
        np.testing.assert_allclose(res.x.numpy(), std.x.numpy(), rtol=2e-3,
                                   atol=2e-4)


def test_facade_refusals_with_mesh():
    a = port.poisson3d_7pt(8)
    mesh = port.ShardMesh(2, "cpu")
    # the device-flavor setup is not ported (the PMIS mesh path is: see
    # tests/test_torch_dist_pmis.py)
    with pytest.raises(NotImplementedError):
        port.AMGSolver(a, port.AMGParams(coarsening="pmis"), mesh=mesh,
                       device="cpu", flavor="device")
    # the refresh records the classical setup: with grid= it is refused
    with pytest.raises(ValueError):
        port.AMGSolver(a, port.AMGParams(), grid=(8, 8, 8), mesh=mesh,
                       device="cpu", refreshable=True)
    with pytest.raises(ValueError):
        # the default device ("cuda") is not the mesh's
        port.AMGSolver(a, port.AMGParams(), grid=(8, 8, 8), mesh=mesh)
    # the pipelined PCG is ported; a variant outside the two is refused
    with pytest.raises(ValueError):
        make_dist_solver(mesh, None, variant="fused")
