"""Port CSR SpMV (the plain twin of omp_amg_tpu_torch/csrc/csr_spmv.cu)
against the reference's routed-ELL Pallas kernel (interpret mode), all four
fused modes, f32 and bf16 values, on the same seeded inputs.

Operators: A_1, P_0 and R_0 of a 16³ 7-point PMIS hierarchy, and a random
3000×3000 matrix whose size is not a routed-block multiple (one of the
routed-format test cases).

Tolerance: max|Δ| ≤ 1e-5·max|ref|. Rows of up to ~100 terms are summed in
another order.

Also the kernel's width rule, ``Csr.vec`` (lanes per row: the largest power
of two at or below half the mean row length, 1 to 32), on every ``Csr`` of
a 24³ PMIS hierarchy built through each constructor, and on the shapes of
the 128³ hierarchy's operators.
"""

import math


import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import omp_amg_tpu as ref
from omp_amg_tpu.amg.hierarchy import amg_setup
from omp_amg_tpu.amg.params import AMGParams
from omp_amg_tpu.ops.pallas_routed import (
    correct_routed, jacobi_routed, residual_routed, spmv_routed,
)
from omp_amg_tpu.sparse.formats import ell_to_scipy
from omp_amg_tpu.sparse.routed import routed_from_scipy, routed_to_scipy
import omp_amg_tpu_torch as amg
from omp_amg_tpu_torch.interop import hierarchy_from_numpy
from omp_amg_tpu_torch.ops import csr_spmv
from omp_amg_tpu_torch.ops.probe_rap import build_rap_probe
from omp_amg_tpu_torch.sparse.formats import (
    Csr, csr_from_ell, csr_from_scipy, ell_planes_from_scipy,
)

torch.set_num_threads(2)

TOL = 1e-5
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
OPERATORS = ["A1", "P0", "R0", "random3000"]
SQUARE = {"A1", "random3000"}


def _random_sparse(n_rows, n_cols, density, seed):
    rng = np.random.default_rng(seed)
    nnz = int(n_rows * n_cols * density)
    m = sp.csr_matrix((rng.standard_normal(nnz),
                       (rng.integers(0, n_rows, nnz),
                        rng.integers(0, n_cols, nnz))),
                      shape=(n_rows, n_cols))
    m.sum_duplicates()
    m.eliminate_zeros()
    return m


@pytest.fixture(scope="module")
def operators():
    hier, ops = amg_setup(ref.poisson3d_7pt(16),
                          AMGParams(coarsening="pmis"), keep_host=True)
    return {"A1": ops[1], "P0": ell_to_scipy(hier.levels[0].p),
            "R0": ell_to_scipy(hier.levels[0].r),
            "random3000": _random_sparse(3000, 3000, 0.004, 1)}


CASES = [(op, mode, dt) for op in OPERATORS
         for mode in ("spmv", "residual", "correct", "jacobi")
         for dt in DTYPES if mode != "jacobi" or op in SQUARE]


@pytest.mark.parametrize("op,mode,dtype", CASES)
def test_csr_modes_match_routed_kernel(operators, op, mode, dtype):
    m = operators[op]
    tdt, jdt = DTYPES[dtype]
    rt = routed_from_scipy(m, dtype=jdt)
    assert rt is not None
    # the plan's own (possibly bf16-rounded) values: both sides multiply
    # exactly the same numbers
    pa = csr_from_scipy(routed_to_scipy(rt), tdt, device="cpu")
    n_rows, n_cols = m.shape
    rng = np.random.default_rng(7)
    x = rng.standard_normal(n_cols).astype(np.float32)
    v = rng.standard_normal(n_rows).astype(np.float32)
    s = rng.uniform(0.1, 0.2, n_rows).astype(np.float32)
    xt, vt, st = (torch.from_numpy(t) for t in (x, v, s))
    xj, vj, sj = (jnp.asarray(t) for t in (x, v, s))
    if mode == "spmv":
        want = spmv_routed(rt, xj, interpret=True)
        got = csr_spmv.spmv(pa, xt)
    elif mode == "residual":
        want = residual_routed(rt, xj, vj, interpret=True)
        got = csr_spmv.residual(pa, xt, vt)
    elif mode == "correct":
        want = correct_routed(rt, xj, vj, interpret=True)
        got = csr_spmv.correct(pa, xt, vt)
    else:
        want = jacobi_routed(rt, xj, vj, sj, interpret=True)
        got = csr_spmv.jacobi(pa, xt, vt, st)
    want = np.asarray(want, np.float64)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = np.abs(got.numpy().astype(np.float64) - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


def test_csr_plain_matches_scipy_with_empty_rows():
    m = sp.csr_matrix(np.array([[0.0, 2.0, 0.0],
                                [0.0, 0.0, 0.0],
                                [1.5, 0.0, -1.0]]))
    x = np.array([1.0, -2.0, 4.0], np.float32)
    y = csr_spmv.spmv(csr_from_scipy(m, device="cpu"), torch.from_numpy(x))
    np.testing.assert_array_equal(y.numpy(), (m @ x).astype(np.float32))


def test_csr_wrapper_checks(operators):
    pa = csr_from_scipy(operators["P0"], device="cpu")
    x = torch.zeros(pa.n_cols)
    before = csr_spmv.launches
    csr_spmv.spmv(pa, x)
    assert csr_spmv.launches == before      # the CPU twin is no launch
    with pytest.raises(ValueError):
        csr_spmv.spmv(pa, torch.zeros(pa.n_cols + 1))
    with pytest.raises(ValueError):
        csr_spmv.jacobi(pa, x, torch.zeros(pa.n_rows), torch.zeros(pa.n_rows))
    with pytest.raises(ValueError):
        csr_spmv.residual(pa, x, torch.zeros(pa.n_rows, dtype=torch.float64))


def _want_vec(n_rows, nnz):
    """The width rule written independently: 2^floor(log2(mean / 2)),
    clipped to [1, 32]."""
    half_mean = nnz / max(n_rows, 1) / 2
    if half_mean < 1:
        return 1
    return min(32, 2 ** math.floor(math.log2(half_mean)))


def _sized_csr(n_rows, nnz):
    """A ``Csr`` with the given sizes and no storage behind them (the rule
    reads only the sizes)."""
    return Csr(indptr=torch.zeros(1, dtype=torch.int64).expand(n_rows + 1),
               indices=torch.zeros(1, dtype=torch.int32).expand(nnz),
               vals=torch.zeros(1).expand(nnz), n_cols=1)


@pytest.mark.parametrize("n_rows,nnz,vec", [
    (2_097_152, 9_074_206, 2),      # P0 of the 128³ PMIS hierarchy
    (647_655, 9_074_206, 4),        # R0
    (647_655, 27_259_875, 16),      # L1-A
    (647_655, 3_505_698, 2),        # P1
    (73_905, 3_505_698, 16),        # R1
    (73_905, 7_856_143, 32),        # L2-A
    (0, 0, 1), (10, 0, 1), (10, 39, 1), (10, 40, 2), (10, 79, 2),
    (10, 80, 4), (10, 10_000, 32),
])
def test_width_rule_on_operator_shapes(n_rows, nnz, vec):
    assert _sized_csr(n_rows, nnz).vec == vec == _want_vec(n_rows, nnz)


@pytest.fixture(scope="module")
def host24():
    """The 24³ PMIS setup's host operators: A_l, P_l and R_l = P_lᵀ."""
    _, host = amg.amg_setup(amg.poisson3d_7pt(24),
                            amg.AMGParams(coarsening="pmis"), device="cpu",
                            keep_host=True)
    return host


def _level_dicts(host):
    out = []
    for l, p_sp in enumerate(host.p):
        lv = {"dinv": 1.0 / host.ops[l].diagonal(), "lmax": 2.0}
        for key, m in (("a", host.ops[l]), ("p", p_sp),
                       ("r", p_sp.T.tocsr())):
            col, val, n_cols = ell_planes_from_scipy(m)
            lv.update({f"{key}_col": col, f"{key}_val": val,
                       f"{key}_n_cols": n_cols})
        out.append(lv)
    return out


def _csrs(host, how):
    """Every ``Csr`` that constructor ``how`` makes of the hierarchy."""
    if how == "csr_from_scipy":
        hier = amg.amg_setup(amg.poisson3d_7pt(24),
                             amg.AMGParams(coarsening="pmis"), device="cpu")
        return [op for lv in hier.levels for op in (lv.a, lv.p, lv.r)
                if isinstance(op, Csr)]
    if how == "csr_from_ell":
        return [csr_from_ell(*ell_planes_from_scipy(m), device="cpu")
                for m in (*host.ops, *host.p, *(p.T.tocsr() for p in host.p))]
    if how == "probe":
        probes = [build_rap_probe(a, p, device="cpu")[0]
                  for a, p in zip(host.ops, host.p)]
        probes = [pr for pr in probes if pr is not None]
        assert probes
        return [op for pr in probes for op in (pr.a, pr.r)]
    hier = hierarchy_from_numpy(_level_dicts(host), np.eye(4),
                                amg.AMGParams(coarsening="pmis"),
                                device="cpu")
    return [op for lv in hier.levels for op in (lv.a, lv.p, lv.r)]


@pytest.mark.parametrize("how", ["csr_from_scipy", "csr_from_ell", "probe",
                                 "hierarchy_from_numpy"])
def test_width_rule_on_every_constructor(host24, how):
    ops = _csrs(host24, how)
    assert ops and all(isinstance(op, Csr) for op in ops)
    widths = [op.vec for op in ops]
    assert widths == [_want_vec(op.n_rows, op.nnz) for op in ops]
    assert all(1 <= v <= 32 and v & (v - 1) == 0 for v in widths)
    # narrow P rows get fewer lanes than the wide coarse rows
    assert min(widths) < max(widths)
