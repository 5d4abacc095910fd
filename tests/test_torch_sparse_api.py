"""The port's public sparse API against the reference's, on the CPU, on the
cases of ``tests/test_sparse.py``:

- ``csr_from_scipy`` / ``csr_to_scipy`` round trips and ``spmv_csr`` on
  random rectangular matrices: the round trip exact, the product within f32
  tolerance of the reference's and of scipy's (rtol 2e-5: f32 sums in
  another order);
- the generators through ``dia_to_scipy``, ``dia_from_scipy``,
  ``dia_to_csr``, ``spmv_dia`` and ``spmv_csr``: equal to the reference's
  matrices, products within f32 tolerance;
- COO assembly sums duplicates;
- ``diagonal`` on ``Dia``, ``Csr`` and ``ConstDia`` equal to the
  reference's;
- ``vcycle_apply`` x + M⁻¹(b − A·x) on a PMIS and a structured 16³
  hierarchy carried over from the reference, against the reference's
  (1e-5 of the largest entry, as one V-cycle);
- the constructors run on the card unless told otherwise: without CUDA they
  raise instead of moving to the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import omp_amg_tpu as ref
from omp_amg_tpu.amg.hierarchy import amg_setup as ref_setup
from omp_amg_tpu.amg.params import AMGParams as RefParams
from omp_amg_tpu.amg.vcycle import vcycle_apply as ref_vcycle_apply
from omp_amg_tpu.ops.spmv import spmv_csr as ref_spmv_csr
from omp_amg_tpu.ops.spmv import spmv_dia as ref_spmv_dia
from omp_amg_tpu.sparse import formats as RF

import omp_amg_tpu_torch as port

torch.set_num_threads(2)


def random_csr(n, m, density, seed):
    rng = np.random.default_rng(seed)
    a = sp.random(n, m, density=density, random_state=rng, format="csr")
    a.data = rng.standard_normal(a.nnz)
    d = sp.coo_matrix((rng.standard_normal(min(n, m)) + 2.0,
                       (np.arange(min(n, m)), np.arange(min(n, m)))),
                      shape=(n, m))
    return (a + d).tocsr()


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("n,m", [(50, 50), (64, 33), (1, 1), (17, 90)])
def test_csr_roundtrip_and_spmv(n, m):
    a = random_csr(n, m, 0.1, seed=n * 100 + m)
    x = np.random.default_rng(1).standard_normal(m)
    acsr = port.csr_from_scipy(a, device="cpu")
    got = port.spmv_csr(acsr, _t(x)).numpy()
    want = np.asarray(ref_spmv_csr(RF.csr_from_scipy(a),
                                   jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(got, a @ x, rtol=2e-5, atol=1e-5)
    back = port.csr_to_scipy(acsr)
    assert (abs(back - RF.csr_to_scipy(RF.csr_from_scipy(a)))).nnz == 0
    assert (abs(back - a) > 1e-6).nnz == 0


@pytest.mark.parametrize("gen,args", [
    ("poisson2d_5pt", (9, 7)),
    ("poisson3d_7pt", (5, 4, 3)),
    ("poisson3d_27pt", (4, 5, 3)),
    ("aniso2d_9pt", (8, 6)),
])
def test_generators_through_the_formats(gen, args):
    a = getattr(port, gen)(*args)
    a_sp = port.dia_to_scipy(a)
    want_sp = RF.dia_to_scipy(getattr(ref, gen)(*args, backend="numpy"))
    assert abs(a_sp - want_sp).max() == 0
    x = np.random.default_rng(3).standard_normal(a.n_rows)
    xt, xj = _t(x), jnp.asarray(x, jnp.float32)
    adia = port.dia_from_scipy(a_sp, device="cpu")
    want = np.asarray(ref_spmv_dia(RF.dia_from_scipy(a_sp), xj))
    got = port.spmv_dia(adia, xt).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(got, a_sp @ x, rtol=2e-5, atol=1e-4)
    acsr = port.dia_to_csr(adia)
    assert acsr.vals.device.type == "cpu"
    assert abs(port.csr_to_scipy(acsr) - a_sp).max() < 1e-6
    np.testing.assert_allclose(port.spmv_csr(acsr, xt).numpy(), a_sp @ x,
                               rtol=2e-5, atol=1e-4)


def test_5pt_diagonal():
    a = port.poisson2d_5pt(6)
    want = np.asarray(RF.diagonal(ref.poisson2d_5pt(6)))
    np.testing.assert_array_equal(np.asarray(port.diagonal(a)), want)
    np.testing.assert_array_equal(
        port.diagonal(port.dia_to_csr(a, device="cpu")).numpy(), want)
    np.testing.assert_allclose(want, 4.0)


def test_coo_assembly_sums_duplicates():
    rows = [0, 0, 1, 2, 2]
    cols = [0, 0, 1, 0, 2]
    vals = [1.0, 2.0, 5.0, 1.0, 4.0]
    a = port.coo_to_csr(rows, cols, vals, shape=(3, 3), device="cpu")
    want = RF.csr_to_scipy(RF.coo_to_csr(rows, cols, vals,
                                         shape=(3, 3))).toarray()
    np.testing.assert_array_equal(port.csr_to_scipy(a).toarray(), want)
    np.testing.assert_allclose(want, [[3, 0, 0], [0, 5, 0], [1, 0, 4]])
    assert a.nnz == 4


@pytest.mark.parametrize("kind", ["dia", "dia-no-centre", "csr",
                                  "csr-rectangular", "constdia"])
def test_diagonal_matches_reference(kind):
    if kind == "constdia":
        a_h = port.poisson3d_27pt(16, 8, 8)
        got = port.diagonal(port.sparse.formats.to_const_dia(a_h, "cpu"))
        want = RF.diagonal(RF.to_const_dia(ref.poisson3d_27pt(
            16, 8, 8, backend="numpy")))
    elif kind.startswith("dia"):
        offsets = (-3, 0, 2) if kind == "dia" else (-3, 2)
        data = np.random.default_rng(2).standard_normal(
            (len(offsets), 20)).astype(np.float32)
        got = port.diagonal(port.Dia(data=torch.from_numpy(data),
                                     offsets=offsets))
        want = RF.diagonal(RF.Dia(data=jnp.asarray(data), offsets=offsets))
    else:
        m = (random_csr(40, 40, 0.2, seed=9) if kind == "csr"
             else random_csr(30, 45, 0.2, seed=10))
        got = port.diagonal(port.csr_from_scipy(m, device="cpu"))
        want = RF.diagonal(RF.csr_from_scipy(m))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def _pmis_levels(hier):
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
    return levels


def _structured_levels(hier):
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
    return levels


@pytest.mark.parametrize("path", ["pmis", "structured"])
def test_vcycle_apply_matches_reference(path):
    n = 16
    a_j = ref.poisson3d_7pt(n, backend="numpy")
    if path == "pmis":
        hier_j = ref_setup(a_j, RefParams(coarsening="pmis"))
        levels = _pmis_levels(hier_j)
    else:
        hier_j = ref_setup(a_j, RefParams(), grid=(n, n, n))
        levels = _structured_levels(hier_j)
    hier_t = port.hierarchy_from_numpy(levels, np.asarray(hier_j.coarse_chol),
                                       hier_j.params, device="cpu")
    rng = np.random.default_rng(6)
    x, b = (rng.standard_normal(n ** 3).astype(np.float32) for _ in range(2))
    want = np.asarray(jax.jit(ref_vcycle_apply)(hier_j, jnp.asarray(x),
                                                jnp.asarray(b)), np.float64)
    got = port.vcycle_apply(hier_t, torch.from_numpy(x),
                            torch.from_numpy(b)).numpy().astype(np.float64)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (err, np.abs(want).max())
    # an exact solution is a fixed point
    xs = port.vcycle_apply(hier_t, torch.zeros(n ** 3), torch.zeros(n ** 3))
    assert torch.count_nonzero(xs) == 0


def test_constructors_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = random_csr(5, 5, 0.5, seed=1)
    a = port.poisson2d_5pt(4)
    for make in (lambda: port.csr_from_scipy(m),
                 lambda: port.coo_to_csr([0], [0], [1.0], (2, 2)),
                 lambda: port.dia_from_scipy(port.dia_to_scipy(a)),
                 lambda: port.dia_to_csr(a)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
