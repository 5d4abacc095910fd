"""The port's colored-probing Galerkin RAP (``ops/probe_rap.py``, the plain
twins of its kernels) against the reference's, on the CPU:

- the distance-2 colouring equals the reference's (native and numpy)
  wherever the reference's finds one (at most 256 colours), a 27-point
  PMIS hierarchy's levels included; above 256 colours, where the reference
  gives up, it is still a valid distance-2 colouring and the numeric phase
  still gives PᵀAP;
- ``rap_probe_numeric`` on real PMIS level pairs, against the reference's
  numeric phase run two ways (``engine="xla"``, and ``engine="pallas"`` in
  interpret mode) and against the host ``galerkin_product``: max|Δ| ≤
  3e-6·max|A_c| (5e-6 above 128 colours), the reference's own bounds (f32
  sums in another order);
- the setup chain with ``rap="probe"`` against ``rap="host"`` and against the
  reference's probe chain, and the certified solve against the reference's;
- a 27-point Chebyshev ``rap="probe"`` solve takes every level's values
  from the probe and certifies as the host-valued setup does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import omp_amg_tpu as ref
from omp_amg_tpu.amg.hierarchy import amg_setup as ref_setup
from omp_amg_tpu.amg.params import AMGParams as RefParams
from omp_amg_tpu.ops import probe_rap as ref_probe
from omp_amg_tpu.ops.rap import galerkin_product as ref_galerkin
from omp_amg_tpu.solvers.cg import amg_pcg as ref_amg_pcg
from omp_amg_tpu.solvers.ir import solve_ir as ref_solve_ir
from omp_amg_tpu.sparse.formats import ell_to_scipy
from omp_amg_tpu.sparse.routed import RoutedEll, routed_to_scipy

import omp_amg_tpu_torch as port
from omp_amg_tpu_torch import native
from omp_amg_tpu_torch.amg import hierarchy
from omp_amg_tpu_torch.ops import probe_rap
from omp_amg_tpu_torch.ops.rap import galerkin_product
from omp_amg_tpu_torch.sparse.formats import ell_planes_from_scipy

torch.set_num_threads(2)

PROBE = dict(coarsening="pmis", interp="extpi", rap="probe")


def _pmis_level_pair(gen, n, lvl=0):
    """(A_l, P_l) of the reference's PMIS hierarchy, as scipy CSR
    (tests/test_probe_rap.py's pairs)."""
    hier, hops = ref_setup(gen(n), RefParams(coarsening="pmis",
                                             interp="extpi"), keep_host=True)
    pop = hier.levels[lvl].p
    p_sp = (routed_to_scipy(pop) if isinstance(pop, RoutedEll)
            else ell_to_scipy(pop))
    return sp.csr_matrix(hops[lvl]), sp.csr_matrix(p_sp)


def _ell_values(ac_sp):
    return ell_planes_from_scipy(ac_sp, dtype=np.float64)[1]


def _same_coloring_as_reference(ac):
    """The port's colourings (native, numpy twin) equal native.cc's capped
    one as the port binds it, and the reference's (native, numpy)."""
    got = probe_rap.d2_color(ac)
    got_np = probe_rap._d2_color_np(ac)
    for want in (native.d2_color(ac), ref_probe.d2_color(ac),
                 ref_probe._d2_color_np(ac)):
        assert want is not None
        for colors, count in (got, got_np):
            np.testing.assert_array_equal(colors, want[0])
            assert count == want[1]
    return got[1]


def test_coloring_identical_to_reference():
    a_sp, p_sp = _pmis_level_pair(ref.poisson3d_7pt, 16)
    _same_coloring_as_reference(galerkin_product(a_sp, p_sp))


def test_coloring_identical_to_reference_on_a_27pt_hierarchy():
    """Every coarse operator of a 27-point PMIS hierarchy at 32³ (ext+i, at
    most 6 entries per P row): rows of 80 to 120 entries."""
    _, host = port.amg_setup(
        port.poisson3d_27pt(32),
        port.AMGParams(coarsening="pmis", interp="extpi", rap="host"),
        device="cpu", keep_host=True)
    counts = [_same_coloring_as_reference(ac) for ac in host.ops[1:]]
    assert len(counts) >= 2 and max(counts) > 64


def _valid_d2(ac, colors):
    """No two columns that share a row share a colour."""
    ac = sp.csr_matrix(ac)
    for i in range(ac.shape[0]):
        row = colors[ac.indices[ac.indptr[i]:ac.indptr[i + 1]]]
        if len(np.unique(row)) != len(row):
            return False
    return True


def _wide_operator():
    """(A, P) whose Galerkin product has a row of 320 entries: row 0 of A
    couples every unknown, and P's column 0 takes in unknown 0."""
    n, nc = 600, 320
    a = sp.random(n, n, density=0.01, random_state=3, format="lil")
    a[0, :] = 1.0 / n
    a = sp.csr_matrix(a + a.T + 10 * sp.eye(n))
    p = sp.random(n, nc, density=0.01, random_state=4, format="lil")
    p[np.arange(nc), np.arange(nc)] = 1.0
    return a, sp.csr_matrix(p)


def test_coloring_above_the_reference_cap_is_valid():
    a, p = _wide_operator()
    ac = galerkin_product(a, p)
    assert np.diff(ac.indptr).max() > 256
    assert native.d2_color(ac) is None and ref_probe.d2_color(ac) is None
    colors, count = probe_rap.d2_color(ac)
    assert count > 256 and count == colors.max() + 1
    assert _valid_d2(ac, colors)
    colors_np, count_np = probe_rap._d2_color_np(ac)
    np.testing.assert_array_equal(colors_np, colors)
    assert count_np == count


def test_numeric_phase_above_the_reference_cap():
    """Three colour groups: the numeric phase against the plain float64
    product PᵀAP (scipy), within the many-colour bound."""
    a, p = _wide_operator()
    probe, ac_sp = probe_rap.build_rap_probe(a, p, device="cpu")
    assert probe.n_colors > 256 and len(probe.groups) == 3
    want = sp.csr_matrix(p.T @ a @ p)
    want.sort_indices()
    got = probe_rap.rap_probe_numeric(probe).numpy().astype(np.float64)
    got_sp = ac_sp.copy()
    got_sp.data = got[probe_rap.ell_slots(ac_sp, got.shape[1])]
    scale = abs(want).max()
    d = abs(got_sp - want)
    assert d.max() <= 5e-6 * scale


def _compare(a_sp, p_sp, bound):
    probe, ac_sp = probe_rap.build_rap_probe(a_sp, p_sp, device="cpu")
    assert probe is not None
    want_host = _ell_values(ac_sp)
    scale = np.abs(want_host).max()
    got = probe_rap.rap_probe_numeric(probe).numpy().astype(np.float64)
    assert got.shape == want_host.shape
    np.testing.assert_allclose(got, want_host, rtol=0, atol=bound * scale)
    ref_pr, ref_ac = ref_probe.build_rap_probe(a_sp, p_sp)
    assert ref_pr is not None and ref_pr.n_colors == probe.n_colors
    np.testing.assert_array_equal(ref_ac.indptr, ac_sp.indptr)
    for engine, interpret in (("xla", False), ("pallas", True)):
        want = np.asarray(ref_probe.rap_probe_numeric(
            ref_pr, engine=engine, interpret=interpret), np.float64)
        np.testing.assert_allclose(want, want_host, rtol=0,
                                   atol=bound * scale)
        np.testing.assert_allclose(got, want, rtol=0, atol=bound * scale,
                                   err_msg=engine)
    return probe


@pytest.mark.parametrize("gen,n,lvl", [
    ("poisson3d_7pt", 24, 0),
    ("poisson3d_7pt", 24, 1),
    ("poisson2d_5pt", 64, 0),
    ("poisson3d_27pt", 12, 0),
])
def test_numeric_phase_matches_reference_engines(gen, n, lvl):
    a_sp, p_sp = _pmis_level_pair(getattr(ref, gen), n, lvl)
    _compare(a_sp, p_sp, 3e-6)


def test_numeric_phase_many_colors():
    """More than 128 colours: two colour groups (tests/test_probe_rap.py's
    random operator)."""
    n, nc = 600, 200
    a = sp.random(n, n, density=0.02, random_state=1, format="csr")
    a = sp.csr_matrix(a + a.T + 10 * sp.eye(n))
    p = sp.csr_matrix(sp.random(n, nc, density=0.05, random_state=2,
                                format="csr"))
    probe = _compare(a, p, 5e-6)
    assert probe.n_colors > 128 and len(probe.groups) == 2


def test_setup_chain_probe_against_host_and_reference():
    a = port.poisson3d_7pt(20)
    _, host = port.amg_setup(a, port.AMGParams(coarsening="pmis",
                                               interp="extpi", rap="host"),
                             device="cpu", keep_host=True)
    _, probe = port.amg_setup(a, port.AMGParams(**PROBE), device="cpu",
                              keep_host=True)
    _, ref_ops = ref_setup(ref.poisson3d_7pt(20), RefParams(**PROBE),
                           keep_host=True)
    assert len(host.ops) == len(probe.ops) == len(ref_ops)
    for lvl, (o1, o2, o3) in enumerate(zip(host.ops, probe.ops, ref_ops)):
        assert o1.nnz == o2.nnz == o3.nnz
        bound = 5e-6 * max(1, 2 * lvl)
        for want in (o1, o3):
            d = abs(o2 - want)
            rel = (d.max() if d.nnz else 0.0) / abs(want).max()
            assert rel < bound, (lvl, rel)


def _reference_solve(n, b):
    solver = ref.AMGSolver(ref.poisson3d_7pt(n, backend="numpy"),
                           RefParams(**PROBE))
    res = ref_solve_ir(solver.a_host, b, solver.a, solver.hierarchy,
                       tol=1e-8, maxiter=500)
    cg = ref_amg_pcg(solver.a,
                     jnp.asarray(b / np.linalg.norm(b), jnp.float32),
                     solver.hierarchy, tol=1e-6, maxiter=500)
    hist = np.asarray(cg.history)
    return res, hist[np.isfinite(hist)].tolist()


@pytest.mark.parametrize("n", [16, 24])
def test_certified_probe_solve_matches_reference(n):
    a = port.poisson3d_7pt(n)
    b_t = port.default_rhs(a, seed=0)
    b = b_t.numpy().astype(np.float64)
    solver = port.AMGSolver(a, port.AMGParams(**PROBE), device="cpu")
    x = solver.solve(b_t, tol=1e-8)
    info = solver.last_info
    res_j, hist_j = _reference_solve(n, b)
    assert info["rel_residual"] <= 1e-8
    assert res_j.rel_residual <= 1e-8
    true_rel = (np.linalg.norm(b - port.dia_to_scipy(a) @ x)
                / np.linalg.norm(b))
    assert true_rel <= 1e-8
    assert info["outer_iters"] == res_j.outer_iters
    diffs = [abs(p - r) for p, r in zip(info["inner_iters"],
                                        res_j.inner_iters)]
    if any(diffs):
        # f32 sum order in the numeric phase moves A_c by ~1e-7 relative
        print(f"{n}^3: port inner {info['inner_iters']}, reference inner "
              f"{list(res_j.inner_iters)}")
        print("reference history outer=0: "
              + " ".join(f"{v:.6e}" for v in hist_j))
        for k, h in enumerate(info["residual_histories"]):
            print(f"port history outer={k}: "
                  + " ".join(f"{v:.6e}" for v in h))
    assert max(diffs, default=0) <= 1


def _stencil27_residual(b, x, n):
    """‖b − A x‖/‖b‖ in float64 for the 27-point Dirichlet Laplacian
    (centre 26, every neighbour −1), by plain PyTorch shifts."""
    xt = torch.as_tensor(np.asarray(x, np.float64)).reshape(n, n, n)
    pad = torch.nn.functional.pad(xt, (1, 1, 1, 1, 1, 1))
    ax = 27.0 * xt
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                ax = ax - pad[dz:dz + n, dy:dy + n, dx:dx + n]
    bt = torch.as_tensor(b, dtype=torch.float64)
    return float(torch.linalg.norm(bt - ax.reshape(-1))
                 / torch.linalg.norm(bt))


def test_27pt_chebyshev_probe_solve_takes_every_level_from_the_probe():
    n = 24
    a = port.poisson3d_27pt(n)
    b = np.random.default_rng(5).standard_normal(n ** 3)
    kw = dict(coarsening="pmis", theta=0.25, interp="extpi",
              interp_max_elements=6, smoother="chebyshev", cheby_degree=3,
              cheby_ratio=30.0, coarse_size=100, coarse_solver="chol")
    before = dict(hierarchy.rap_products)
    probe = port.AMGSolver(a, port.AMGParams(rap="probe", **kw),
                           device="cpu")
    levels = len(probe.hierarchy.levels)
    assert probe.hierarchy.rap_engines == ("probe",) * levels
    assert hierarchy.rap_products["probe"] - before.get("probe", 0) == levels
    assert hierarchy.rap_products["host"] == before.get("host", 0)
    host = port.AMGSolver(a, port.AMGParams(rap="host", **kw), device="cpu")
    assert host.hierarchy.rap_engines == ("host",) * levels
    x = probe.solve(b, tol=1e-8)
    info = dict(probe.last_info)
    host.solve(b, tol=1e-8)
    assert info["certified_f64"] and info["rel_residual"] <= 1e-8
    assert _stencil27_residual(b, x, n) <= 1e-8
    assert info["outer_iters"] == host.last_info["outer_iters"]
    # the probe's f32 sums run in another order than the host product's
    # f64 ones: A_c moves by ~1e-7 relative, at most one inner iteration
    diffs = [abs(p - h) for p, h in zip(info["inner_iters"],
                                        host.last_info["inner_iters"])]
    assert max(diffs, default=0) <= 1, (info["inner_iters"],
                                        host.last_info["inner_iters"])
