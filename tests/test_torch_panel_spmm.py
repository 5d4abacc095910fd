"""Port panel SpMM and lane extraction (the plain twins of
omp_amg_tpu_torch/csrc/panel_spmm.cu and extract_lanes.cu) against the
reference's Pallas kernels in interpret mode, on the same seeded inputs.

- ``spmm_panel`` against each of ``_spmm_kernel`` (``spmm_panel``),
  ``_spmm_v2_kernel`` (``spmm_panel_v2``) and ``_spmm_roll_kernel``
  (``spmm_panel_roll``), all at ``precision="bf16x3"`` (f32-exact), on the
  operators and seeds of ``tests/test_panel_spmm.py``; and against scipy in
  f64. Bound: max|Δ| ≤ 3e-6·max|ref|, the reference's own bound against
  scipy (f32 sums in another order).
- The twin equals a row-by-row sequential numpy f32 sum bit for bit, as the
  kernel does by construction (explicit rounding, CSR order).
- ``extract_lanes`` equals the reference's exactly (a copy).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from omp_amg_tpu.ops.pallas_spmm import (
    ROLL_DC, build_plan_v2, roll_ring_chunks, spmm_panel_roll, spmm_panel_v2,
    split_bf16,
)
from omp_amg_tpu.ops.pallas_spmm import extract_lanes as ref_extract_lanes
from omp_amg_tpu.ops.pallas_spmm import spmm_panel as ref_spmm_panel
from omp_amg_tpu.sparse.panels import (
    pack_panels, panel_plan_from_dict, panel_plan_from_scipy, plan_panel_spmm,
    unpack_panels,
)
from omp_amg_tpu_torch.ops import extract_lanes, panel_spmm
from omp_amg_tpu_torch.sparse.formats import csr_from_scipy

torch.set_num_threads(2)

TOL = 3e-6


def _rand_sparse(rng, n, m, row_nnz, banded=2000):
    """tests/test_panel_spmm.py's operator generator."""
    rows = np.repeat(np.arange(n), row_nnz)
    cols = np.clip(rows * m // n + rng.integers(-banded, banded, len(rows)),
                   0, m - 1)
    a = sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                      shape=(n, m))
    a.sum_duplicates()
    return a


def _roll_operator(rng, n, nc, band, shuffle):
    """tests/test_panel_spmm.py::test_roll_kernel_matches_v1's operator."""
    rows = np.repeat(np.arange(n), 5)
    cols = np.clip(rows * nc // n + rng.integers(-band, band + 1, len(rows)),
                   0, nc - 1)
    if shuffle:
        sel = rng.integers(0, len(rows), len(rows) // 50)
        cols[sel] = rng.integers(0, nc, len(sel))
    m = sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                      shape=(n, nc))
    m.sum_duplicates()
    return m


def _case(name):
    """(operator, panel X) of one reference test case, from its seed."""
    if name == "v1_640x520_C128":
        rng = np.random.default_rng(2)
        a = _rand_sparse(rng, 640, 520, 4, banded=80)
        c = 128
    elif name in ("v2_900x700_C64", "v2_300x4096_C32"):
        n, m, k, c = (900, 700, 5, 64) if name.startswith("v2_900") \
            else (300, 4096, 40, 32)
        rng = np.random.default_rng(7)
        a = _rand_sparse(rng, n, m, k, banded=max(60, m // 4))
    elif name.startswith("roll"):
        rng = np.random.default_rng(11)
        a = _roll_operator(rng, 2048, 3000, 60, name.endswith("shuffle"))
        c = 16
    else:   # the K-chunked operator (K > 32 slots per row block)
        rng = np.random.default_rng(3)
        a = _rand_sparse(rng, 256, 4096, 40, banded=2048)
        c = 64
    x = rng.standard_normal((a.shape[1], c)).astype(np.float32)
    return a, x


def _reference(name, a, x):
    """The reference kernel of the case, in interpret mode, f32-exact."""
    c = x.shape[1]
    if name.startswith("v2"):
        plan = build_plan_v2(a, c)
        xt = pack_panels(jnp.asarray(x), plan.nxp)
        ut = spmm_panel_v2(plan, split_bf16(xt, 3), precision="bf16x3",
                           interpret=True)
        return np.asarray(unpack_panels(ut[: -(-a.shape[0] // 128) * c],
                                        a.shape[0], c))
    if name.startswith("roll"):
        d = plan_panel_spmm(a, dtype=np.float64)
        plan = panel_plan_from_dict(d, jnp.float32)
        nb = d["val"].shape[0]
        hi = jnp.asarray(np.maximum(d["block_hi"], d["sbase"][0, :nb] + 1)
                         .astype(np.int32))
        xt = pack_panels(jnp.asarray(x), -(-plan.nxp // ROLL_DC) * ROLL_DC)
        ut = spmm_panel_roll(plan, hi, roll_ring_chunks(d),
                             split_bf16(xt, 3), c, precision="bf16x3",
                             interpret=True)
        return np.asarray(unpack_panels(ut, a.shape[0], c))
    plan = panel_plan_from_scipy(a)
    xt = pack_panels(jnp.asarray(x), plan.nxp)
    ut = ref_spmm_panel(plan, split_bf16(xt, 3), c, precision="bf16x3",
                        interpret=True)
    return np.asarray(unpack_panels(ut, a.shape[0], c))


KERNEL_CASES = ["v1_640x520_C128", "v2_900x700_C64", "v2_300x4096_C32",
                "roll_2048x3000_C16", "roll_2048x3000_C16_shuffle"]


def _port(a, x):
    pa = csr_from_scipy(a, torch.float32, device="cpu")
    return panel_spmm.spmm_panel(pa, torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_spmm_panel_matches_reference_kernel(name):
    a, x = _case(name)
    want = _reference(name, a, x)
    got = _port(a, x)
    assert got.shape == want.shape == (a.shape[0], x.shape[1])
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("name", KERNEL_CASES + ["kchunked_256x4096_C64"])
def test_spmm_panel_matches_scipy(name):
    a, x = _case(name)
    want = a @ x.astype(np.float64)
    err = np.abs(_port(a, x) - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


def _sequential_f32(a, x):
    """Row by row, nonzero by nonzero in CSR order: acc = acc + v·x[col]
    with every product and sum rounded to f32."""
    vals = a.data.astype(np.float32)
    out = np.zeros((a.shape[0], x.shape[1]), np.float32)
    for i in range(a.shape[0]):
        acc = np.zeros(x.shape[1], np.float32)
        for j in range(a.indptr[i], a.indptr[i + 1]):
            acc = acc + vals[j] * x[a.indices[j]]
        out[i] = acc
    return out


@pytest.mark.parametrize("name", ["v1_640x520_C128", "kchunked_256x4096_C64"])
def test_spmm_panel_twin_is_the_sequential_f32_sum(name):
    a, x = _case(name)
    np.testing.assert_array_equal(_port(a, x), _sequential_f32(a, x))


def test_spmm_panel_empty_rows_and_narrow_panels():
    rng = np.random.default_rng(5)
    a = sp.csr_matrix(np.array([[0.0, 2.0, 0.0, 1.0],
                                [0.0, 0.0, 0.0, 0.0],
                                [1.5, 0.0, -1.0, 0.0]]))
    for c in (1, 5, 33, 128):
        x = rng.standard_normal((4, c)).astype(np.float32)
        got = _port(a, x)
        np.testing.assert_array_equal(got, _sequential_f32(a, x))
        assert not got[1].any()
    empty = csr_from_scipy(sp.csr_matrix((0, 4)), device="cpu")
    assert panel_spmm.spmm_panel(empty, torch.zeros(4, 8)).shape == (0, 8)


def test_spmm_panel_wrapper_checks():
    a = csr_from_scipy(sp.random(6, 5, density=0.5, random_state=0,
                                 format="csr"), device="cpu")
    before = panel_spmm.launches
    panel_spmm.spmm_panel(a, torch.zeros(5, 8))
    assert panel_spmm.launches == before      # the CPU twin is no launch
    for bad in (torch.zeros(6, 8), torch.zeros(5, 129), torch.zeros(5, 0),
                torch.zeros(5, 8, dtype=torch.float64), torch.zeros(5)):
        with pytest.raises(ValueError):
            panel_spmm.spmm_panel(a, bad)
    with pytest.raises(ValueError):
        panel_spmm.spmm_panel(a, torch.zeros(8, 5).t())   # not contiguous
    with pytest.raises(TypeError):
        panel_spmm.spmm_panel(
            csr_from_scipy(sp.eye(5, format="csr"), torch.bfloat16,
                           device="cpu"), torch.zeros(5, 8))


def test_lane_plan_covers_every_column_once():
    """For every panel width C in 1..128, the kernel's lane mapping
    (``lane_plan``, ``lane_columns``): a row's group of lanes owns each of
    the C columns exactly once, the groups fill a warp, and the vector
    instance (q > 0) serves exactly the widths that 32 divides, each lane
    with four consecutive aligned columns (one 16-byte load)."""
    for c in range(1, panel_spmm.MAX_COLS + 1):
        q, group, rows_per_warp = panel_spmm.lane_plan(c)
        assert group * rows_per_warp == 32
        cols = panel_spmm.lane_columns(c)
        assert len(cols) == group
        assert sorted(k for lane in cols for k in lane) == list(range(c)), c
        assert (q > 0) == (c % 32 == 0)
        if q:
            assert c == 32 * q and 8 * q <= group
            for lane in filter(None, cols):
                assert lane[0] % 4 == 0
                assert lane == list(range(lane[0], lane[0] + 4))
        else:
            assert rows_per_warp == 1 and max(map(len, cols)) <= 4


def test_extract_lanes_matches_reference_kernel():
    rng = np.random.default_rng(9)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    idx = rng.integers(0, 128, (256, 256)).astype(np.int32)
    want = np.asarray(ref_extract_lanes(jnp.asarray(w), jnp.asarray(idx),
                                        interpret=True))
    got = extract_lanes.extract_lanes(torch.from_numpy(w),
                                      torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


def test_extract_lanes_any_width():
    rng = np.random.default_rng(10)
    w = rng.standard_normal((37, 200)).astype(np.float32)
    idx = rng.integers(0, 200, (37, 11)).astype(np.int32)
    got = extract_lanes.extract_lanes(torch.from_numpy(w),
                                      torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(),
                                  np.take_along_axis(w, idx, axis=1))
    before = extract_lanes.launches
    with pytest.raises(ValueError):
        extract_lanes.extract_lanes(torch.from_numpy(w),
                                    torch.from_numpy(idx).long())
    with pytest.raises(ValueError):
        extract_lanes.extract_lanes(torch.from_numpy(w),
                                    torch.from_numpy(idx[:5]))
    assert extract_lanes.launches == before
