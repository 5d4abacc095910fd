"""The tiled CSR form (``sparse/formats.py::TileCsr``) and its kernel's
plain twin (``ops/tile_csr.py``), on the CPU.

- The twin is bitwise ``csr_spmv_plain`` in every mode, f32 and bf16, on
  A₁, A₂ and R₁ of the 48³ 7-point PMIS hierarchy (the operators of the
  ``pmis7_256`` configuration's kind, in the tiled form built directly),
  and on a random operator whose tiles end at the 65,536 distinct columns
  a 16-bit index reaches.
- The rule (``tile_rule``; ``tiled_form`` applies it in ``make_level`` to
  operators on the card only, so a CPU level keeps its ``Csr``) reads the
  operator only: it gives the form to a coarse-like operator of long rows above
  ``TILE_MIN_NNZ`` (the size from which the tiled kernel beat the CSR
  kernel on the H100; 256³'s A₁ and A₂ hold 220 M and 64 M nonzeros), and
  keeps on ``Csr`` the same operator below it, short rows, and every
  operator of the 48³ hierarchy (A₁ and A₂ pass its other tests there).
- A refresh of tiled levels keeps the tiles and gives the values of a
  fresh setup; a saved hierarchy holds the global CSR, and a loaded one
  the same tensors; ``ops.launch_counts()`` lists the tiled kernel's
  counter. (These take the 48³ hierarchy with the form given to every A
  and R of 8 lanes or more, whatever the size.)
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import omp_amg_tpu_torch as amg
from omp_amg_tpu_torch import ops
from omp_amg_tpu_torch.ops import csr_spmv, tile_csr as tile_ops
from omp_amg_tpu_torch.ops.spmv import jacobi, residual, spmv
from omp_amg_tpu_torch.amg.hierarchy import Hierarchy, make_level
from omp_amg_tpu_torch.sparse.formats import (
    TILE_MAX_COLS, TILE_MAX_UNIQUE_SHARE, TILE_MIN_NNZ, TILE_MIN_ROW_LEN,
    TILE_NNZ, TILE_WINDOW, Csr, TileCsr, csr_from_scipy, csr_to_scipy,
    tile_csr, tile_rule, tile_to_csr, tiled_form,
)

torch.set_num_threads(2)

MODES = ("spmv", "residual", "correct", "jacobi")
PMIS = amg.AMGParams(coarsening="pmis")


@pytest.fixture(scope="module")
def hier48():
    return amg.amg_setup(amg.poisson3d_7pt(48), PMIS, device="cpu")


def _csr(op):
    return tile_to_csr(op) if isinstance(op, TileCsr) else op


def _forced(hier):
    """``hier`` with every A and R of 8 lanes or more in the tiled form,
    whatever their size (the rule keeps the 48³ operators on ``Csr``)."""
    def tiled(op):
        if isinstance(op, Csr) and op.vec >= 8:
            return tile_csr(op)
        return op
    return dataclasses.replace(hier, levels=tuple(
        dataclasses.replace(lv, a=tiled(lv.a), r=tiled(lv.r))
        for lv in hier.levels))


def _operands(a, seed):
    rng = np.random.default_rng(seed)

    def vec(n):
        return torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return vec(a.n_cols), vec(a.n_rows), vec(a.n_rows), vec(a.n_rows)


def _both(t: TileCsr, c: Csr, mode, seed=0):
    x, b, v, s = _operands(c, seed)
    got = tile_ops.tile_csr_plain(t, x, mode, v=v, b=b, s=s)
    want = csr_spmv.csr_spmv_plain(c, x, mode, v=v, b=b, s=s)
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("which,mode", [
    (w, m) for w in ("A1", "A2", "R1") for m in MODES
    if (w, m) != ("R1", "jacobi")])      # jacobi: square operators only
def test_twin_bitwise_csr_twin_on_the_48_hierarchy(hier48, which, mode,
                                                   dtype):
    l, name = int(which[1]), which[0].lower()
    c = _csr(getattr(hier48.levels[l], name))
    c = dataclasses.replace(c, vals=c.vals.to(dtype))
    t = tile_csr(c)
    assert t is not None and t.vec == c.vec >= 8
    got, want = _both(t, c, mode, seed=l)
    assert torch.equal(got, want)


def _wide_random(per=300, n_rows=1200, n_cols=4_000_000, seed=3):
    """Rows of ``per`` random columns out of ``n_cols``: a tile of a few
    hundred such rows passes 65,536 distinct columns unless the cut ends
    it."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_rows), per)
    cols = rng.integers(0, n_cols, rows.size)
    m = sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(n_rows, n_cols))
    m.sum_duplicates()
    return csr_from_scipy(m, device="cpu")


@pytest.mark.parametrize("mode", ["spmv", "residual", "correct"])
def test_twin_bitwise_where_tiles_end_at_the_16_bit_cut(mode):
    c = _wide_random()
    t = tile_csr(c, window=1 << 20, nnz=1 << 20)
    counts = t.tile_ptr.diff()
    assert int(counts.max()) == t.window <= TILE_MAX_COLS < c.nnz
    assert t.n_tiles > 1 and t.window > TILE_MAX_COLS // 2
    # the local indices reach past 2¹⁵: stored as int16, read unsigned
    assert int(t.indices.min()) < 0
    assert torch.equal(tile_to_csr(t).indices, c.indices)
    got, want = _both(t, c, mode)
    assert torch.equal(got, want)


def _check_layout(c, t, window):
    """Tiles within their window, every row in one tile, each tile's list
    its rows' distinct columns, sorted."""
    rows = t.tile_rows
    assert int(rows[0]) == 0 and int(rows[-1]) == c.n_rows
    assert bool((rows.diff() > 0).all())
    assert t.window == int(t.tile_ptr.diff().max()) <= window
    longest = int(c.indptr.diff().max())
    assert int(c.indptr[rows].diff().max()) < TILE_NNZ + longest
    r0, r1 = rows[:-1], rows[1:]
    for k in (0, t.n_tiles // 2, t.n_tiles - 1):
        s, e = int(c.indptr[r0[k]]), int(c.indptr[r1[k]])
        want = torch.unique(c.indices[s:e])
        got = t.tile_cols[int(t.tile_ptr[k]):int(t.tile_ptr[k + 1])]
        assert torch.equal(got, want.to(torch.int32))


def test_tiles_fit_their_window_and_split_where_they_must(hier48):
    c = _csr(hier48.levels[1].a)
    t = tile_csr(c)
    _check_layout(c, t, TILE_WINDOW)
    # a window a twelfth as large: more, smaller tiles, still exact
    small = tile_csr(c, window=TILE_WINDOW // 12)
    _check_layout(c, small, TILE_WINDOW // 12)
    assert small.n_tiles > 2 * t.n_tiles
    assert small.unique_share > t.unique_share
    assert torch.equal(tile_to_csr(small).indices, c.indices)
    # a window below one row's columns: no form
    assert tile_csr(c, window=8) is None


def _coarse_like(n_rows, dx=2, seed=5):
    """Rows of a 3D coarse operator's shape: columns at every offset
    dz·4096 + dy·64 + ddx (|dz|, |dy| ≤ 1, |ddx| ≤ dx) around the row, so
    neighbouring rows share most of their columns."""
    offs = torch.tensor([dz * 4096 + dy * 64 + d for dz in (-1, 0, 1)
                         for dy in (-1, 0, 1) for d in range(-dx, dx + 1)])
    pad = int(offs.abs().max())
    cols = (torch.arange(n_rows)[:, None] + pad + offs[None, :]).reshape(-1)
    gen = torch.Generator().manual_seed(seed)
    vals = torch.randn(cols.numel(), generator=gen)
    indptr = torch.arange(n_rows + 1, dtype=torch.int64) * offs.numel()
    return Csr(indptr=indptr, indices=cols.to(torch.int32), vals=vals,
               n_cols=n_rows + 2 * pad)


def test_rule_tiles_a_coarse_like_operator_above_the_threshold():
    big = _coarse_like(TILE_MIN_NNZ // 45 + 1000)        # 45 a row
    assert big.nnz >= TILE_MIN_NNZ and big.vec == 16
    t = tile_rule(big)
    assert isinstance(t, TileCsr) and t.vals is big.vals
    assert 0 < t.unique_share <= TILE_MAX_UNIQUE_SHARE
    assert torch.equal(tile_to_csr(t).indices, big.indices)
    # on the CPU the form has no kernel: the level keeps the Csr
    small = _coarse_like(100)
    assert tiled_form(big) is big
    lv = make_level(big, np.ones(big.n_rows), 2.0, small, small, PMIS,
                    "cpu")
    assert lv.a is big and isinstance(lv.r, Csr)
    # the record on a hierarchy: which (level, operator), with its share
    lv = dataclasses.replace(lv, a=t)
    hier = Hierarchy(levels=(lv,), coarse_chol=torch.eye(2), params=PMIS)
    assert hier.tiled == ((0, "a", t.unique_share),)
    assert hier.tiled_nnz_share == big.nnz / (big.nnz + 2 * small.nnz)
    # below the threshold: Csr
    below = _coarse_like(TILE_MIN_NNZ // 45 - 1000)
    assert tile_rule(below) is None and tiled_form(below) is below


def test_rule_keeps_the_48_hierarchy_on_csr(hier48):
    assert hier48.tiled == () and hier48.tiled_nnz_share == 0.0
    for l, lv in enumerate(hier48.levels):
        for name, op in (("a", lv.a), ("p", lv.p), ("r", lv.r)):
            if not isinstance(op, Csr):
                continue
            assert tile_rule(op) is None and tiled_form(op) is op
            long_rows = op.nnz >= TILE_MIN_ROW_LEN * op.n_rows
            # P and R₀: short rows; A₁, A₂: long rows whose tiles share
            # their columns, below the size only
            assert long_rows == ((l, name) in ((1, "a"), (1, "r"),
                                               (2, "a"), (2, "r"),
                                               (3, "a"), (3, "r")))
            if (l, name) in ((1, "a"), (2, "a")):
                assert op.nnz < TILE_MIN_NNZ
                assert tile_csr(op).unique_share <= TILE_MAX_UNIQUE_SHARE


@pytest.fixture(scope="module")
def tiled48(hier48):
    return _forced(hier48)


def test_dispatch_runs_the_tiled_form_as_the_csr(tiled48):
    lv = tiled48.levels[1]
    assert isinstance(lv.a, TileCsr)
    c = _csr(lv.a)
    x, b, _, _ = _operands(c, 7)
    assert torch.equal(spmv(lv.a, x), csr_spmv.spmv(c, x))
    assert torch.equal(residual(lv.a, x, b), csr_spmv.residual(c, x, b))
    assert torch.equal(jacobi(lv.a, x, b, lv.s),
                       csr_spmv.jacobi(c, x, b, lv.s))
    before = tile_ops.launches
    spmv(lv.a, x)
    assert tile_ops.launches == before          # the twin counts nothing


def test_wrapper_checks(tiled48):
    t = tiled48.levels[1].a
    x = torch.zeros(t.n_cols)
    with pytest.raises(ValueError):
        tile_ops.spmv(t, torch.zeros(t.n_cols + 1))
    with pytest.raises(ValueError):
        tile_ops.residual(t, x, torch.zeros(t.n_rows, dtype=torch.float64))
    with pytest.raises(TypeError):
        tile_ops.spmv(dataclasses.replace(t, indices=t.indices.int()), x)
    with pytest.raises(TypeError):
        tile_ops.spmv(dataclasses.replace(t, vals=t.vals.double()), x)
    narrow = dataclasses.replace(t, indptr=t.indptr.clone())
    narrow.__dict__["vec"] = 4
    with pytest.raises(ValueError):
        tile_ops.spmv(narrow, x)


def test_scipy_and_diagonal_decode_the_tiles(tiled48):
    t = tiled48.levels[2].a
    c = tile_to_csr(t)
    a_sp = csr_to_scipy(t)
    assert (a_sp != csr_to_scipy(c)).nnz == 0
    assert torch.equal(amg.diagonal(t), amg.diagonal(c))


def test_refresh_keeps_the_tiles_and_gives_fresh_values():
    a = amg.poisson3d_7pt(48)
    cache = amg.SetupCache()
    h0 = _forced(amg.amg_setup(a, PMIS, device="cpu", cache=cache))
    cache.hier = h0                  # the setup's levels, tiled
    # ×2 is exact: the fresh setup makes the same choices (ties included)
    a2 = dataclasses.replace(a, data=np.asarray(a.data) * 2.0)
    h = amg.amg_refresh(a2, cache)
    fresh = amg.amg_setup(a2, PMIS, device="cpu")
    assert [(l, n) for l, n, _ in h.tiled] == \
        [(l, n) for l, n, _ in h0.tiled] == [(1, "a"), (1, "r"), (2, "a"),
                                             (2, "r"), (3, "a"), (3, "r")]
    for l, name, _ in h.tiled:
        old, new, want = (getattr(hh.levels[l], name)
                          for hh in (h0, h, fresh))
        # the cached index tensors, the new values in CSR order
        for field in ("indptr", "indices", "tile_rows", "tile_ptr",
                      "tile_cols"):
            assert getattr(new, field) is getattr(old, field)
        # new values (R = Pᵀ: interpolation weights do not scale)
        assert torch.equal(new.vals, old.vals) == (name == "r")
        # a fresh setup's operator to f32 roundoff
        want = _csr(want)
        assert torch.equal(tile_to_csr(new).indices, want.indices)
        diff = abs(csr_to_scipy(new) - csr_to_scipy(want)).max()
        assert diff <= 1e-5 * abs(csr_to_scipy(want)).max()


def test_save_load_round_trip_writes_the_global_csr(tiled48, tmp_path):
    path = tmp_path / "h48.npz"
    amg.save_hierarchy(path, tiled48)
    with np.load(path) as z:
        assert z["l1:a:indices"].dtype == np.int32     # the global CSR
    back = amg.load_hierarchy(path, device="cpu")
    # the rule gives the loaded operators their form: here, below its
    # size, the CSR every one of them decodes to
    assert back.tiled == ()
    for lv, lw in zip(back.levels, tiled48.levels):
        for name in ("a", "p", "r"):
            og, ow = getattr(lv, name), _csr(getattr(lw, name))
            assert type(og) is type(ow)
            if isinstance(ow, Csr):
                for f in dataclasses.fields(ow):
                    got, want = getattr(og, f.name), getattr(ow, f.name)
                    assert (torch.equal(got, want)
                            if isinstance(want, torch.Tensor)
                            else got == want)


def test_launch_counts_list_the_tiled_kernel():
    counts = ops.launch_counts()
    assert "tile_csr" in counts and "csr_spmv" in counts
    assert counts["tile_csr"] == tile_ops.launches
