"""The port's row-sharded PMIS distribution against the reference's, on the
CPU (the reference on conftest's 8 virtual CPU devices, the port on
``ShardMesh(d, "cpu")``):

- ``dist_pmis_setup(keep_host=True)``: the C/F split, P, A_c, the ELL
  planes of every operator, ``dinv``, ``lmax`` and the coarse matrix
  bitwise the reference's on 1, 2 and 4 shards (3D 7-point 16³, 2D 5-point
  32²);
- the partition: halo columns never reach a wrapped strip (the reference's
  circular exchange and the port's zero-filled one agree);
- ``dist_spmv`` in halo, gather and replicated mode and the transition's
  restriction and prolongation on the reference's own partition carried
  over by ``dist_hierarchy_from_numpy`` (1e-6 of the largest entry), and
  one V-cycle (rtol 1e-5);
- the certified counts (inner per outer pass, outer) equal the reference's
  for standard and pipelined PCG and Chebyshev on 1, 2 and 4 shards, for a
  fully replicated hierarchy, and for the central route (ext+i not asked:
  ``amg_setup`` plus ``partition_hierarchy``); on bench.py's 2d5pt,
  aniso9pt (θ = 0.5) and 27-point Chebyshev configs at CPU sizes the mesh
  counts on 1, 2 and 4 shards equal the reference's serial ones; the two
  halo transports give the same bits; a structured hierarchy that does not
  split into z-slabs takes the row partition;
- the distributed refresh: equal to a fresh setup and bitwise the
  reference's refresh (×2.0 and the non-dyadic ×1.7 with its tie repair),
  the pattern guard, the guard on a P nonzero dropped after the repair and
  the 1e-7 dropped-Galerkin guard; the facade with ``refreshable=True``;
- the certified residual is the user's f64 operator's: on 24³ × 1.7 both
  mesh paths give a scipy f64 residual ≤ 2e-8 (the z-slab path reported
  1.8e-9 and met 1.3e-7 when it formed the residual from its f32 blocks).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import omp_amg_tpu as ref
from omp_amg_tpu.amg.params import AMGParams as RefParams
from omp_amg_tpu.parallel.dist import (
    AXIS, _op_spec, dist_spmv as ref_dist_spmv,
    make_dist_vcycle as ref_make_dist_vcycle,
    prolong_from_replicated as ref_prolong,
    restrict_to_replicated as ref_restrict,
)
from omp_amg_tpu.parallel.dist_ir import (
    make_dist_ir_solver as ref_make_dist_ir_solver,
)
from omp_amg_tpu.parallel.dist_pmis_setup import (
    DistSetupCache as RefDistCache, dist_pmis_refresh as ref_dist_refresh,
    dist_pmis_setup as ref_dist_setup,
)
from omp_amg_tpu.parallel.partition import pad_vector as ref_pad_vector

import omp_amg_tpu_torch as port
from omp_amg_tpu_torch.amg import host_setup as hs
from omp_amg_tpu_torch.amg import refresh
from omp_amg_tpu_torch.ops import spmv as port_ops
from omp_amg_tpu_torch.parallel.dist import (
    DistOp, dist_op_apply, make_dist_vcycle, restrict_to_replicated,
)
from omp_amg_tpu_torch.parallel.dist_ir import fine_f64, make_dist_ir_solver
from omp_amg_tpu_torch.parallel.partition import pad_vector, with_transport
from omp_amg_tpu_torch.sparse.formats import Csr, Dia, dia_to_scipy

torch.set_num_threads(2)

N3 = 16
AGG = 64    # 16³ on 4 shards: L0 halo, L1 gather, L2 replicated


def _ref_mesh(d):
    return jax.make_mesh((d,), (AXIS,))


def _scale(a, s):
    return Dia(data=np.asarray(a.data) * s, offsets=a.offsets, dims=a.dims)


def _ref_scale(a, s):
    """The reference's operator from the port's f64 planes (its generators
    round to f32, which a non-dyadic factor would then round apart)."""
    return ref.Dia(data=np.asarray(a.data) * s, offsets=a.offsets,
                   dims=a.dims)


def _rhs(a):
    return port.default_rhs(a, seed=0).numpy().astype(np.float64)


def _ell_dist_to_numpy(dh):
    """The reference's ELL ``DistHierarchy`` as the level dicts of
    ``dist_hierarchy_from_numpy``."""
    def op(o):
        if o is None:
            return None
        return dict(col=np.asarray(o.col), val=np.asarray(o.val),
                    mode=o.mode, halo=o.halo, m_in=o.m_in,
                    n_in_real=o.n_in_real)

    levels = [dict(sharded=lv.sharded, next_sharded=lv.next_sharded,
                   n_next=lv.n_next, dinv=np.asarray(lv.dinv),
                   lmax=float(lv.lmax), a=op(lv.a), p=op(lv.p), r=op(lv.r))
              for lv in dh.levels]
    return levels, np.asarray(dh.coarse_chol)


@pytest.fixture(scope="module")
def carried():
    """The reference's 16³ partition on 4 shards (L0 halo, L1 gather, L2
    replicated), carried into the port on both transports."""
    mesh_j = _ref_mesh(4)
    dh_j = ref_dist_setup(ref.poisson3d_7pt(N3), 4,
                          RefParams(coarsening="pmis"), mesh=mesh_j,
                          agg_rows_per_dev=AGG)
    levels, chol = _ell_dist_to_numpy(dh_j)
    mesh = port.ShardMesh(4, "cpu")
    dhs = {t: port.dist_hierarchy_from_numpy(levels, chol, dh_j.params,
                                             mesh, transport=t)
           for t in ("ppermute", "remote")}
    return mesh_j, dh_j, mesh, dhs


# --- the setup ---------------------------------------------------------------

@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("gen,n", [("poisson3d_7pt", N3),
                                   ("poisson2d_5pt", 32)])
def test_setup_bitwise_reference(gen, n, ndev):
    prm = dict(coarsening="pmis")
    cache_j, cache = RefDistCache(), port.DistSetupCache()
    _, hier_j, ops_j = ref_dist_setup(getattr(ref, gen)(n), ndev,
                                      RefParams(**prm), keep_host=True,
                                      cache=cache_j)
    dh, host = port.dist_pmis_setup(getattr(port, gen)(n), ndev,
                                    port.AMGParams(**prm), keep_host=True,
                                    cache=cache)
    assert len(host.levels) == len(hier_j.levels) >= 2
    for l, (lv, lj) in enumerate(zip(host.levels, hier_j.levels)):
        np.testing.assert_array_equal(lv["state"], cache_j.levels[l]["state"])
        for name in ("a", "p", "r"):
            col, val, n_cols = lv[name]
            oj = getattr(lj, name)
            what = f"L{l} {name}"
            np.testing.assert_array_equal(col, np.asarray(oj.col), what)
            np.testing.assert_array_equal(val, np.asarray(oj.val), what)
            assert n_cols == oj.n_cols
        np.testing.assert_array_equal(lv["dinv"], np.asarray(lj.dinv))
        assert lv["lmax"] == float(lj.lmax)
    np.testing.assert_array_equal(host.coarse_a, np.asarray(hier_j.coarse_a))
    np.testing.assert_array_equal(host.coarse_chol,
                                  np.asarray(hier_j.coarse_chol))
    assert len(host.ops) == len(ops_j)
    for m, mj in zip(host.ops, ops_j):
        np.testing.assert_array_equal(m.indptr, mj.indptr)
        np.testing.assert_array_equal(m.indices, mj.indices)
        np.testing.assert_array_equal(m.data, mj.data)
    assert len(dh.levels) == len(host.levels)


def test_halo_columns_never_reach_a_wrapped_strip(carried):
    """Shard 0's valid columns start at its own block and the last shard's
    end in it, so the reference's circular strips are never read and the
    port's zero-filled ends give the same windows; padding slots point at
    window index h with value 0 (dropped on the way to CSR)."""
    _, dh_j, mesh, dhs = carried
    halos = 0
    for lv_j, lv in zip(dh_j.levels, dhs["remote"].levels):
        for name in ("a", "p", "r"):
            o = getattr(lv_j, name)
            if o is None or o.mode != "halo":
                continue
            halos += 1
            col, val = np.asarray(o.col), np.asarray(o.val)
            m_out = col.shape[0] // 4
            valid = val != 0
            assert (col[~valid] == o.halo).all()
            assert (col[:m_out][valid[:m_out]] >= o.halo).all()
            assert (col[-m_out:][valid[-m_out:]] < o.halo + o.m_in).all()
            port_op = getattr(lv, name)
            assert isinstance(port_op, DistOp)
            assert port_op.mode == "halo" and port_op.halo == o.halo
            # the blocks hold only the valid slots
            assert sum(b.nnz for b in port_op.blocks) == int(valid.sum())
    assert halos >= 2


def _ref_apply(mesh_j, fn, op, x, rows_sharded, in_spec, out_spec):
    f = jax.jit(jax.shard_map(fn, mesh=mesh_j,
                              in_specs=(_op_spec(op, rows_sharded), in_spec),
                              out_specs=out_spec, check_vma=False))
    return np.asarray(f(op, jnp.asarray(x)))


@pytest.mark.parametrize("transport", ["ppermute", "remote"])
@pytest.mark.parametrize("case", ["halo", "halo-restrict", "gather",
                                  "replicated", "transition-restrict",
                                  "transition-prolong"])
def test_dist_spmv_matches_reference(carried, case, transport):
    mesh_j, dh_j, mesh, dhs = carried
    dh = dhs[transport]
    rng = np.random.default_rng(3)
    sh = P(AXIS)
    lvl, name = {"halo": (0, "a"), "halo-restrict": (0, "r"),
                 "gather": (1, "a"), "replicated": (2, "a"),
                 "transition-restrict": (1, "p"),
                 "transition-prolong": (1, "p")}[case]
    lv_j, lv = dh_j.levels[lvl], dh.levels[lvl]
    op_j, op = getattr(lv_j, name), getattr(lv, name)
    if case == "replicated":
        assert isinstance(op, Csr) and not lv.sharded
        x = rng.standard_normal(op.n_cols).astype(np.float32)
        want = _ref_apply(mesh_j, ref_dist_spmv, op_j, x, False, P(), P())
        got = port_ops.spmv(op, torch.from_numpy(x)).numpy()
    elif case == "transition-restrict":
        assert lv.r is None and op.mode == "replicated"
        x = rng.standard_normal(op.n_rows).astype(np.float32)
        nc = lv.n_next
        want = _ref_apply(mesh_j, lambda o, r: ref_restrict(o, r, nc), op_j,
                          x, True, sh, P())
        got = restrict_to_replicated(op, mesh.shard(
            torch.from_numpy(x))).numpy()
    elif case == "transition-prolong":
        x = rng.standard_normal(lv.n_next).astype(np.float32)
        want = _ref_apply(mesh_j, ref_prolong, op_j, x, True, P(), sh)
        got = torch.cat(dist_op_apply(op, torch.from_numpy(x))).numpy()
    else:
        assert op.mode == case.split("-")[0]
        assert op.transport == transport
        x = rng.standard_normal(op.n_in).astype(np.float32)
        rows_sharded = lv.sharded if name == "a" else lv.next_sharded
        want = _ref_apply(mesh_j, ref_dist_spmv, op_j, x, rows_sharded, sh,
                          sh)
        got = torch.cat(dist_op_apply(op, mesh.shard(
            torch.from_numpy(x)))).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("transport", ["ppermute", "remote"])
def test_vcycle_on_reference_partition(carried, transport):
    mesh_j, dh_j, mesh, dhs = carried
    dh = dhs[transport]
    b = np.random.default_rng(4).standard_normal(
        dh.levels[0].a.n_rows).astype(np.float32)
    want = np.asarray(ref_make_dist_vcycle(mesh_j, dh_j)(dh_j,
                                                         jnp.asarray(b)))
    got = make_dist_vcycle(mesh, dh)(dh, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# --- the certified counts ----------------------------------------------------

OPTIONS = {"standard": ({}, "standard"), "pipelined": ({}, "pipelined"),
           "chebyshev": ({"smoother": "chebyshev"}, "standard")}


@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_certified_counts_equal_reference(option, ndev):
    kw, variant = OPTIONS[option]
    a_j, a = ref.poisson3d_7pt(N3), port.poisson3d_7pt(N3)
    b = _rhs(a)
    mesh_j = _ref_mesh(ndev)
    dh_j = ref_dist_setup(a_j, ndev, RefParams(coarsening="pmis", **kw),
                          mesh=mesh_j, agg_rows_per_dev=AGG)
    res_j = ref_make_dist_ir_solver(mesh_j, dh_j, tol=1e-8, maxiter=200,
                                    variant=variant)(
        dh_j, ref_pad_vector(b, dh_j, ndev))
    mesh = port.ShardMesh(ndev, "cpu")
    dh = port.dist_pmis_setup(a, ndev, port.AMGParams(coarsening="pmis",
                                                      **kw),
                              mesh=mesh, agg_rows_per_dev=AGG,
                              transport="remote")
    res = make_dist_ir_solver(mesh, dh, fine_f64(a, dh, mesh.device),
                              tol=1e-8, maxiter=200, variant=variant)(
        dh, pad_vector(b, dh, ndev))
    assert res.inner_iters == list(res_j.inner_iters)
    assert res.outer_iters == res_j.outer_iters
    assert res.rel_residual <= 1e-8
    true_rel = (np.linalg.norm(b - dia_to_scipy(a) @ res.x[:a.n_rows])
                / np.linalg.norm(b))
    assert true_rel <= 2e-8


# bench.py's PMIS configs beyond 7-point 16³ at CPU sizes (the generator,
# its size and the PMIS parameters bench.py gives it); the mesh's certified
# counts are held to the reference's serial solve, since the reference's own
# mesh counts change with the partition on aniso9pt (ROADMAP Queue 3)
MESH_CONFIGS = {
    "2d5pt_32": ("poisson2d_5pt", 32, {}),
    "aniso9pt_32_theta0.5": ("aniso2d_9pt", 32, {"theta": 0.5}),
    "27pt_12_cheby": ("poisson3d_27pt", 12, {"smoother": "chebyshev"}),
}
_SERIAL_COUNTS = {}


def _reference_serial_counts(config):
    if config not in _SERIAL_COUNTS:
        from omp_amg_tpu.solvers.ir import solve_ir as ref_solve_ir

        gen, n, kw = MESH_CONFIGS[config]
        a_j = getattr(ref, gen)(n, backend="numpy")
        b = _rhs(getattr(port, gen)(n))
        solver_j = ref.AMGSolver(a_j, RefParams(coarsening="pmis", **kw))
        res = ref_solve_ir(solver_j.a_host, b, solver_j.a,
                           solver_j.hierarchy, tol=1e-8, maxiter=500)
        _SERIAL_COUNTS[config] = (list(res.inner_iters), res.outer_iters)
    return _SERIAL_COUNTS[config]


@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("config", list(MESH_CONFIGS))
def test_mesh_counts_equal_reference_serial(config, ndev):
    """The facade's certified PMIS solve on a mesh (the captured-block
    steps, run as the eager block loop here) takes the reference's serial
    inner counts per outer pass and outer count."""
    gen, n, kw = MESH_CONFIGS[config]
    a = getattr(port, gen)(n)
    b = _rhs(a)
    solver = port.AMGSolver(a, port.AMGParams(coarsening="pmis", **kw),
                            mesh=port.ShardMesh(ndev, "cpu"), device="cpu",
                            transport="remote", agg_rows_per_dev=AGG)
    x = solver.solve(b, tol=1e-8)
    info = solver.last_info
    inner, outer = _reference_serial_counts(config)
    if (info["inner_iters"], info["outer_iters"]) != (inner, outer):
        for k, h in enumerate(info["residual_histories"]):
            print(f"{config} d={ndev} history outer={k}: "
                  + " ".join(f"{v:.6e}" for v in h))
    assert info["inner_iters"] == inner
    assert info["outer_iters"] == outer
    assert info["rel_residual"] <= 1e-8
    true_rel = (np.linalg.norm(b - dia_to_scipy(a) @ x) / np.linalg.norm(b))
    assert true_rel <= 2e-8


def test_transports_bitwise_equal():
    """The same hierarchy switched to the other halo exchange
    (``with_transport``) solves to the same bits in the same counts."""
    a = port.poisson3d_7pt(N3)
    b = _rhs(a)
    mesh = port.ShardMesh(4, "cpu")
    dh = port.dist_pmis_setup(a, 4, port.AMGParams(coarsening="pmis"),
                              mesh=mesh, agg_rows_per_dev=AGG,
                              transport="remote")
    a64 = fine_f64(a, dh, mesh.device)
    runs = []
    for h in (dh, with_transport(dh, "ppermute")):
        assert {lv.a.transport for lv in h.levels if lv.sharded} == {
            "remote" if h is dh else "ppermute"}
        runs.append(make_dist_ir_solver(mesh, h, a64, tol=1e-8)(
            h, pad_vector(b, h, 4)))
    assert runs[0].inner_iters == runs[1].inner_iters
    assert np.array_equal(runs[0].x, runs[1].x)


def test_facade_matches_reference_and_one_shard():
    """The acceptance call: 16³ on 4 shards with the default
    ``agg_rows_per_dev`` (every level replicated), certified, in the JAX
    facade's counts and the port's own 1-shard run's."""
    a_j, a = ref.poisson3d_7pt(N3), port.poisson3d_7pt(N3)
    b_t = port.default_rhs(a, seed=0)
    b = b_t.numpy().astype(np.float64)
    solver_j = ref.AMGSolver(a_j, RefParams(coarsening="pmis"),
                             mesh=_ref_mesh(4))
    res_j = ref_make_dist_ir_solver(_ref_mesh(4), solver_j.hierarchy,
                                    tol=1e-8, maxiter=500)(
        solver_j.hierarchy, ref_pad_vector(b, solver_j.hierarchy, 4))
    infos = {}
    for d in (4, 1):
        solver = port.AMGSolver(a, port.AMGParams(coarsening="pmis"),
                                mesh=port.ShardMesh(d, "cpu"), device="cpu")
        x = solver.solve(b_t, tol=1e-8)
        infos[d] = solver.last_info
        assert infos[d]["certified_f64"] and infos[d]["distributed"]
        assert infos[d]["rel_residual"] <= 1e-8
        assert x.shape == (a.n_rows,)
        true_rel = np.linalg.norm(b - dia_to_scipy(a) @ x) / np.linalg.norm(b)
        assert true_rel <= 2e-8
        if d == 4:
            assert solver.stats()["sharded"] == [False] * 3
            z = solver.precondition(b_t)
            assert z.shape == (a.n_rows,) and torch.isfinite(z).all()
    assert infos[4]["inner_iters"] == list(res_j.inner_iters)
    assert infos[4]["outer_iters"] == res_j.outer_iters
    assert (infos[1]["inner_iters"], infos[1]["outer_iters"]) == (
        infos[4]["inner_iters"], infos[4]["outer_iters"])


def test_central_route_counts_equal_reference():
    """Standard interpolation: the per-shard setup refuses it (ValueError)
    and both facades partition the central setup."""
    prm = dict(coarsening="pmis", interp="standard")
    a_j, a = ref.poisson3d_7pt(N3), port.poisson3d_7pt(N3)
    b = _rhs(a)
    mesh_j = _ref_mesh(4)
    solver_j = ref.AMGSolver(a_j, RefParams(**prm), mesh=mesh_j,
                             agg_rows_per_dev=AGG)
    res_j = ref_make_dist_ir_solver(mesh_j, solver_j.hierarchy, tol=1e-8,
                                    maxiter=500)(
        solver_j.hierarchy, ref_pad_vector(b, solver_j.hierarchy, 4))
    with pytest.raises(ValueError):
        port.dist_pmis_setup(a, 4, port.AMGParams(**prm))
    solver = port.AMGSolver(a, port.AMGParams(**prm),
                            mesh=port.ShardMesh(4, "cpu"), device="cpu",
                            agg_rows_per_dev=AGG, transport="remote")
    assert [getattr(lv.a, "mode", None) for lv in solver.hierarchy.levels] \
        == [getattr(lv.a, "mode", None) if lv.sharded else None
            for lv in solver_j.hierarchy.levels]
    solver.solve(b, tol=1e-8)
    assert solver.last_info["inner_iters"] == list(res_j.inner_iters)
    assert solver.last_info["outer_iters"] == res_j.outer_iters


def test_structured_hierarchy_takes_the_ell_partition():
    """16³ on 3 shards does not split into z-slabs: the structured
    hierarchy is partitioned by rows (its ``ConstDia`` and grid transfers
    as ELL planes) and solves in the serial structured counts."""
    a = port.poisson3d_7pt(N3)
    b = port.default_rhs(a, seed=0)
    solver = port.AMGSolver(a, port.AMGParams(), grid=(N3,) * 3,
                            mesh=port.ShardMesh(3, "cpu"), device="cpu",
                            agg_rows_per_dev=AGG, transport="remote")
    assert all(isinstance(lv.a, DistOp) for lv in solver.hierarchy.levels)
    solver.solve(b, tol=1e-8)
    serial = port.AMGSolver(a, port.AMGParams(), grid=(N3,) * 3,
                            device="cpu")
    serial.solve(b, tol=1e-8)
    assert solver.last_info["inner_iters"] == serial.last_info["inner_iters"]
    assert solver.last_info["rel_residual"] <= 1e-8


# --- the distributed refresh -------------------------------------------------

def _host_values(host):
    return [(lv["p"][1], lv["a"][1], lv["r"][1], lv["dinv"], lv["lmax"])
            for lv in host.levels]


@pytest.mark.parametrize("factor", [2.0, 1.7])
def test_refresh_equals_fresh_and_reference(factor):
    """×2.0 equals a fresh setup of the new operator (values to f32
    roundoff, structure exact); ×1.7 flips ext+i near-ties, repaired with
    the cached pattern pinned. Both are bitwise the reference's refresh and
    the same on 1, 2 and 4 shards."""
    a_j, a = ref.poisson3d_7pt(20), port.poisson3d_7pt(20)
    prm = dict(coarsening="pmis")
    repaired = []
    real = hs.extpi_pinned_rows
    first = None
    for ndev in (1, 2, 4):
        cache, cache_j = port.DistSetupCache(), RefDistCache()
        port.dist_pmis_setup(a, ndev, port.AMGParams(**prm), cache=cache)
        ref_dist_setup(a_j, ndev, RefParams(**prm), cache=cache_j)
        hs.extpi_pinned_rows = lambda *args: (repaired.append(ndev),
                                              real(*args))[1]
        try:
            _, host = port.dist_pmis_refresh(_scale(a, factor), cache,
                                             keep_host=True)
        finally:
            hs.extpi_pinned_rows = real
        _, hier_j, ops_j = ref_dist_refresh(_ref_scale(a, factor), cache_j,
                                            keep_host=True)
        for lv, lj, lc in zip(host.levels, hier_j.levels, cache.levels):
            np.testing.assert_array_equal(lv["p"][0], lc["p_col"])
            np.testing.assert_array_equal(lv["p"][1], np.asarray(lj.p.val))
            np.testing.assert_array_equal(lv["a"][1], np.asarray(lj.a.val))
            np.testing.assert_array_equal(lv["r"][1], np.asarray(lj.r.val))
            np.testing.assert_array_equal(lv["dinv"], np.asarray(lj.dinv))
        for m, mj in zip(host.ops, ops_j):
            np.testing.assert_array_equal(m.data, mj.data)
        if first is None:
            first = _host_values(host)
        else:
            for u, v in zip(first, _host_values(host)):
                for s, t in zip(u, v):
                    np.testing.assert_array_equal(s, t)
        if factor == 2.0:
            _, fresh = port.dist_pmis_setup(_scale(a, factor), ndev,
                                            port.AMGParams(**prm),
                                            keep_host=True)
            for lv, lf in zip(host.levels, fresh.levels):
                for name in ("a", "p", "r"):
                    np.testing.assert_array_equal(lv[name][0], lf[name][0])
                    np.testing.assert_allclose(lv[name][1], lf[name][1],
                                               rtol=2e-6, atol=1e-7)
                np.testing.assert_allclose(lv["dinv"], lf["dinv"],
                                           rtol=2e-6)
                np.testing.assert_allclose(lv["lmax"], lf["lmax"],
                                           rtol=1e-4)
    assert bool(repaired) == (factor == 1.7)


def test_refresh_guards():
    """A strength change raises ``PatternChangedError``; so do a P nonzero
    that the tie repair leaves at exactly 0 (the cached transpose
    permutation would misalign) and an eliminated Galerkin entry above the
    guard; the ×1.7 residue passes the 1e-7 guard, and a guard below it
    trips."""
    a = port.poisson2d_5pt(24)
    cache = port.DistSetupCache()
    port.dist_pmis_setup(a, 2, port.AMGParams(coarsening="pmis"),
                         cache=cache)
    data = np.asarray(a.data).copy()
    for i, o in enumerate(a.offsets):
        if abs(o) == 1:
            data[i] *= 1e-6
    with pytest.raises(port.PatternChangedError, match="strength"):
        port.dist_pmis_refresh(Dia(data=data, offsets=a.offsets,
                                   dims=a.dims), cache)

    a = port.poisson3d_7pt(20)
    cache = port.DistSetupCache()
    port.dist_pmis_setup(a, 2, port.AMGParams(coarsening="pmis"),
                         cache=cache)
    real = hs.extpi_pinned_rows

    def drop_one(*args):
        rows = real(*args).copy()
        rows[0, np.flatnonzero(rows[0])[0]] = 0.0
        return rows
    hs.extpi_pinned_rows = drop_one
    try:
        with pytest.raises(port.PatternChangedError, match="nonzeros"):
            port.dist_pmis_refresh(_scale(a, 1.7), cache)
    finally:
        hs.extpi_pinned_rows = real
    # 24³: level 0 has Galerkin entries the setup eliminated
    a = port.poisson3d_7pt(24)
    cache = port.DistSetupCache()
    port.dist_pmis_setup(a, 2, port.AMGParams(coarsening="pmis"),
                         cache=cache)
    assert len(cache.levels[0]["dropped"]) > 0
    assert refresh.DROPPED_TOL == 1e-7
    port.dist_pmis_refresh(_scale(a, 1.7), cache)
    tol = refresh.DROPPED_TOL
    refresh.DROPPED_TOL = 1e-10
    try:
        with pytest.raises(port.PatternChangedError, match="eliminated"):
            port.dist_pmis_refresh(_scale(a, 1.7), cache)
    finally:
        refresh.DROPPED_TOL = tol


def test_facade_refresh_on_a_mesh():
    a = port.poisson3d_7pt(N3)
    b = port.default_rhs(a, seed=0)
    mesh = port.ShardMesh(4, "cpu")
    prm = port.AMGParams(coarsening="pmis")
    solver = port.AMGSolver(a, prm, mesh=mesh, device="cpu",
                            agg_rows_per_dev=AGG, refreshable=True,
                            transport="remote")
    x1 = solver.solve(b, tol=1e-8)
    a4 = _scale(a, 4.0)
    solver.refresh(a4)
    x4 = solver.solve(b, tol=1e-8)
    np.testing.assert_allclose(x4, x1 / 4.0, rtol=1e-6, atol=1e-9)
    fresh = port.AMGSolver(a4, prm, mesh=mesh, device="cpu",
                           agg_rows_per_dev=AGG, transport="remote")
    fresh.solve(b, tol=1e-8)
    assert solver.last_info["inner_iters"] == fresh.last_info["inner_iters"]
    assert solver.last_info["certified_f64"]
    # a pattern change warns and sets up afresh on the mesh
    data = np.asarray(a.data).copy()
    data[list(a.offsets).index(1)] *= 1e-6
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        solver.refresh(Dia(data=data, offsets=a.offsets, dims=a.dims))
    assert any("re-setup" in str(m.message) for m in w)
    solver.solve(b, tol=1e-8)
    assert solver.last_info["rel_residual"] <= 1e-8
    assert solver.hierarchy.nshards == 4
    # a mesh solver built without the flag, or with grid=, refuses
    with pytest.raises(ValueError):
        fresh.refresh(a)
    with pytest.raises(ValueError):
        port.AMGSolver(a, prm, grid=(N3,) * 3, mesh=mesh, device="cpu",
                       refreshable=True)


# --- the certified residual is the user's operator's -------------------------

@pytest.mark.parametrize("path", ["z-slab", "pmis"])
def test_certified_residual_is_the_f64_operators(path):
    """24³ × 1.7: the values are not f32-exact. The certificate must hold
    for the user's f64 operator (scipy), not for the f32 level 0."""
    a = _scale(port.poisson3d_7pt(24), 1.7)
    b = _rhs(a)
    kw = (dict(params=port.AMGParams(), grid=(24,) * 3) if path == "z-slab"
          else dict(params=port.AMGParams(coarsening="pmis"),
                    agg_rows_per_dev=AGG))
    solver = port.AMGSolver(a, mesh=port.ShardMesh(4, "cpu"), device="cpu",
                            transport="remote", **kw)
    x = solver.solve(b, tol=1e-8)
    true_rel = np.linalg.norm(b - dia_to_scipy(a) @ x) / np.linalg.norm(b)
    assert solver.last_info["rel_residual"] <= 1e-8
    assert true_rel <= 2e-8, true_rel
