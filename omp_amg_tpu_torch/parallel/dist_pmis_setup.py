"""Distributed (per-shard) PMIS setup: strength → PMIS → ext+i → RAP with
ghost-row semantics (counterpart of
``omp_amg_tpu/parallel/dist_pmis_setup.py``).

Every setup step runs per row-block shard on the shard's owned rows plus
explicitly gathered ghost data, and the result is bit-identical across
shard counts: the deterministic hash01 PMIS weights make the C/F selection
partition-invariant. It is host numpy plus the native kernels of
``csrc/native.cc`` (through :mod:`..native` and :mod:`..amg.host_setup`),
as the reference's is; its shards are row ranges of one host process.

Exchange pattern per level (what a multi-host run communicates; the
single-process orchestration moves the same owner → ghost slices):

1. ghost A rows (graph distance ≤ 2): ext+i reads the strong-F
   neighbours' rows; the shard-local Gustavson RAP reads A·P rows for its
   contributing fine rows;
2. per PMIS round: the keys and states of the halo rows, then the round's
   new C selections of the halo rows;
3. a prefix sum of the per-shard coarse counts for the global numbering;
4. ghost P rows (distance ≤ 2) for the shard-local triple product.

Bit parity across shard counts (``tests/test_torch_dist_pmis.py``):
strength, PMIS and the stranded-F promotion are elementwise or max
operations on identical inputs; ext+i is per-row deterministic on a compact
ghost system that keeps the column order; each coarse row's Gustavson
accumulation order (its contributing fine rows ascending) is the serial
product's; λmax sums over canonical 1024-row blocks, whatever the
partition.

The hierarchy is partitioned by :func:`.partition.partition_ell` and, with
a ``mesh``, placed on its device. Two faults of the reference's distributed
refresh are not copied: after the ext+i tie repair the refreshed P's
pattern is checked against the cached transpose permutation
(``p_sp.nnz == len(pt_perm)``, else :class:`PatternChangedError`), and the
dropped-Galerkin guard is :data:`..amg.refresh.DROPPED_TOL` (1e-7 of the
largest entry), not 1e-6. The reference's ``routed=`` plans are TPU
layouts; the port has none.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..amg import host_setup as hs
from ..amg.params import AMGParams

_CANON_BLOCK = 1024


def _canon_sum(x: np.ndarray) -> float:
    """Shard-count-invariant reduction: fixed 1024-row block partials
    summed in block order (owners of straddled blocks exchange the few
    boundary rows so every partial covers exactly its rows)."""
    x = np.asarray(x, np.float64)
    if x.size == 0:
        return 0.0
    partials = np.add.reduceat(x, np.arange(0, x.size, _CANON_BLOCK))
    return float(np.sum(partials))


def _canon_norm(x: np.ndarray) -> float:
    return float(np.sqrt(_canon_sum(np.asarray(x, np.float64) ** 2)))


def _shard_ranges(n: int, ndev: int):
    m = -(-n // ndev)
    return [(s * m, min((s + 1) * m, n)) for s in range(ndev)]


def _row_cols(a_csr, rows: np.ndarray) -> np.ndarray:
    """Unique columns of a set of rows (vectorised CSR slice-gather)."""
    lo = a_csr.indptr[rows]
    hi = a_csr.indptr[rows + 1]
    lens = (hi - lo).astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.int64)
    pos = (np.arange(total, dtype=np.int64)
           - np.repeat(np.cumsum(lens) - lens, lens)
           + np.repeat(lo.astype(np.int64), lens))
    return np.unique(a_csr.indices[pos].astype(np.int64))


def _ghost_ids(a_csr, r0: int, r1: int, dist: int) -> np.ndarray:
    """Global ids within graph distance ``dist`` of the owned rows (the
    ghost set a shard requests from its neighbours)."""
    cur = np.arange(r0, r1, dtype=np.int64)
    out = []
    for _ in range(dist):
        nxt = _row_cols(a_csr, cur)
        nxt = nxt[(nxt < r0) | (nxt >= r1)]
        out.append(nxt)
        cur = nxt
    return (np.unique(np.concatenate(out)) if out
            else np.empty(0, np.int64))


def _strength_mask_ranges(col, val, theta, ranges):
    """Per-shard strength masks with globally correct row ids (the formula
    of ``host_setup.strength_mask_np``, row-block local)."""
    n, k = col.shape
    mask = np.zeros((n, k), bool)
    for (r0, r1) in ranges:
        c = col[r0:r1]
        v = val[r0:r1]
        rows = np.arange(r0, r1, dtype=col.dtype)[:, None]
        is_diag = c == rows
        is_pad = v == 0
        offdiag = ~is_diag & ~is_pad
        diag = np.where(is_diag, v, 0).sum(axis=1, keepdims=True)
        sign = np.where(diag >= 0, 1.0, -1.0).astype(v.dtype)
        s = np.where(offdiag, -sign * v, 0)
        row_max = s.max(axis=1, keepdims=True)
        mask[r0:r1] = offdiag & (s > 0) & (s >= theta * row_max) \
            & (row_max > 0)
    return mask


def _pmis_distributed(col, mask, ranges, max_rounds=64):
    """PMIS with per-shard round updates and explicit ghost exchanges,
    bit-identical to the serial ``pmis_np``: the weights are the global
    hash01 plus influence counts; each round every shard updates only its
    owned rows from (key, state, candidacy) of its own and ghost rows."""
    n = col.shape[0]
    # influence counts: per-shard partial bincounts, owner-summed (exact:
    # integer addition commutes)
    cnt = np.zeros(n, np.int64)
    for (r0, r1) in ranges:
        cnt += np.bincount(col[r0:r1][mask[r0:r1]].ravel(), minlength=n)
    weight = cnt.astype(np.float32) + hs.hash01_np(np.arange(n))

    adj, valid = hs._sym_adjacency(col, mask)

    state = np.zeros(n, np.int32)
    key = np.full(n, -1.0, np.float32)
    for _ in range(max_rounds):
        und = state == hs.UNDECIDED
        if not und.any():
            break
        key[:] = -1.0
        key[und] = weight[und]
        # phase A: candidacy of the owned undecided rows (reads ghost keys)
        cand = np.zeros(n, bool)
        for (r0, r1) in ranges:
            u = np.flatnonzero(und[r0:r1]) + r0
            if len(u) == 0:
                continue
            adj_u, valid_u = adj[u], valid[u]
            kn = key[adj_u]
            kn[~valid_u] = -1.0
            nb_key = kn.max(axis=1, initial=-1.0)
            nb_idx = np.where(valid_u & (kn == nb_key[:, None]), adj_u,
                              -1).max(axis=1, initial=-1)
            ku = weight[u]
            cand[u[(ku > nb_key) | ((ku == nb_key) & (u > nb_idx))]] = True
        # exchange the ghost candidacy; phase B: state updates per shard
        for (r0, r1) in ranges:
            u = np.flatnonzero(und[r0:r1]) + r0
            if len(u) == 0:
                continue
            adj_u, valid_u = adj[u], valid[u]
            has_c = (cand[adj_u] & valid_u).any(axis=1)
            cu = cand[u]
            state[u[cu]] = hs.CPOINT
            state[u[~cu & has_c]] = hs.FPOINT
    else:
        raise RuntimeError("distributed PMIS did not terminate")

    # stranded-F promotion (row-local; reads ghost states)
    is_c = state == hs.CPOINT
    out = state.copy()
    for (r0, r1) in ranges:
        sl = slice(r0, r1)
        dep_c = (mask[sl] & is_c[col[sl]]).any(axis=1)
        any_dep = mask[sl].any(axis=1)
        out[sl] = np.where((state[sl] == hs.FPOINT) & any_dep & ~dep_c,
                           hs.CPOINT, state[sl])
    return out


def _extpi_shard(a_csr, r0, r1, ghosts2, state, cmap, n_coarse, theta,
                 max_elements):
    """Ext+i P rows of the owned rows, from the shard's compact ext system:
    rows of own ∪ ghost ids, columns remapped to the (sorted) ext id space.
    Distance-2 ghost rows lose their distance-3 columns, which only
    corrupts rows the shard never keeps (ext+i reads full rows only at
    distance ≤ 1)."""
    import scipy.sparse as sp

    from ..sparse.formats import ell_planes_from_scipy

    own = np.arange(r0, r1, dtype=np.int64)
    ext = np.unique(np.concatenate([own, ghosts2]))
    lookup = np.full(a_csr.shape[0], -1, np.int64)
    lookup[ext] = np.arange(len(ext))
    sub = a_csr[ext].tocoo()
    cl = lookup[sub.col]
    keep = cl >= 0
    sub_l = sp.csr_matrix((sub.data[keep], (sub.row[keep], cl[keep])),
                          shape=(len(ext), len(ext)))
    col_l, val_l, _ = ell_planes_from_scipy(sub_l, dtype=np.float32)
    # strength over the compact system equals the global mask rows (local
    # diagonal ids map 1:1; the kept columns of rows at distance ≤ 1 are
    # their true columns)
    mask_l = hs.strength_mask_np(col_l, val_l, theta)
    pc, pv = hs.extpi_interpolation(col_l, val_l, mask_l, state[ext],
                                    cmap[ext], n_coarse, max_elements)
    own_l = lookup[own]
    return pc[own_l], pv[own_l]


class DistSetupCache:
    """Symbolic record of a per-shard PMIS setup (``dist_pmis_setup(
    cache=)``): strength masks, C/F states, the coarse numbering, the
    interpolation patterns and the per-shard Galerkin patterns, everything
    :func:`dist_pmis_refresh` needs to rebuild the values only of a
    same-sparsity operator (the distributed form of
    :class:`..amg.refresh.SetupCache`)."""

    def __init__(self):
        self.levels = []
        self.params = None
        self.ndev = None
        self.part_kw = None
        self.mesh = None


@dataclass(frozen=True)
class DistHostSetup:
    """The assembled host hierarchy of a per-shard setup (``keep_host=
    True``): per level a dict of the ELL planes ``a``, ``p`` and ``r``
    (``(col, val f32, n_cols)`` triples), ``dinv`` (f32), ``lmax`` (an f32
    value) and the C/F ``state``; the densified coarsest operator and its
    coarse-solve matrix (f32); ``ops``, the scipy operators A_l (f64), one
    more than the levels."""

    levels: list
    coarse_a: np.ndarray
    coarse_chol: np.ndarray
    ops: list


def _fine_csr(a):
    import scipy.sparse as sp

    from ..sparse.formats import dia_to_scipy

    if hasattr(a, "offsets"):
        a_sp = sp.csr_matrix(dia_to_scipy(a))
    else:
        a_sp = sp.csr_matrix(a)
    a_sp = a_sp.astype(np.float64)
    a_sp.sort_indices()
    return a_sp


def _dinv(cur, params) -> np.ndarray:
    if params.smoother == "l1jacobi":
        return 1.0 / np.asarray(np.abs(cur).sum(axis=1)).ravel()
    return 1.0 / cur.diagonal()


def _host_level(cur, p_col, p_val, pt, dinv_np, lmax, state) -> dict:
    from ..sparse.formats import ell_planes_from_scipy

    return dict(a=ell_planes_from_scipy(cur, dtype=np.float32),
                p=(p_col, np.asarray(p_val, np.float32), int(pt.shape[0])),
                r=ell_planes_from_scipy(pt, dtype=np.float32),
                dinv=np.asarray(dinv_np, np.float32),
                lmax=float(np.float32(lmax)), state=state)


def _finish(levels, last, params, ndev, mesh, part_kw, host_ops,
            keep_host):
    """Coarse factor, partition, placement; the optional host record."""
    from ..amg.hierarchy import _coarse_factor
    from .partition import partition_ell, place_hierarchy

    dense = np.asarray(last.toarray(), np.float64)
    fac = _coarse_factor(dense, params).astype(np.float32)
    dh = partition_ell(levels, fac, params, ndev, **part_kw)
    if mesh is not None:
        dh = place_hierarchy(dh, mesh)
    if keep_host:
        return dh, DistHostSetup(levels=levels,
                                 coarse_a=dense.astype(np.float32),
                                 coarse_chol=fac, ops=host_ops)
    return dh


def dist_pmis_setup(a, ndev: int, params: AMGParams = AMGParams(),
                    mesh=None, agg_rows_per_dev: int = 2048,
                    keep_host: bool = False, transport: str = "ppermute",
                    cache: "DistSetupCache | None" = None):
    """Per-shard PMIS hierarchy setup over ``ndev`` row-block shards of
    ``a`` (a ``Dia`` or a scipy sparse matrix).

    Returns the sharded :class:`~.dist.DistHierarchy`, placed on ``mesh``
    when given (a ``ShardMesh`` of ``ndev`` shards; over processes every
    rank runs this whole host setup, as the reference's processes do, and
    places its own shards; without a mesh it keeps host arrays);
    ``keep_host=True`` returns ``(dh, DistHostSetup)``. The host hierarchy is bit-identical for every ``ndev``. ``cache`` (a
    :class:`DistSetupCache`) records the symbolic decisions for
    :func:`dist_pmis_refresh`. Raises ValueError for an interpolation other
    than ext+i (the facade then partitions a central setup).
    """
    import scipy.sparse as sp

    from .. import native
    from ..amg.hierarchy import check_supported
    from ..amg.refresh import _i32
    from ..sparse.formats import ell_planes_from_scipy, ell_planes_to_scipy
    from ..utils.memtune import tune_malloc
    from .slab import check_transport

    check_supported(params)
    check_transport(transport)
    if params.interp != "extpi":
        raise ValueError("dist_pmis_setup implements the ext+i default")
    if mesh is not None and mesh.size != ndev:
        raise ValueError(f"a mesh of {mesh.size} shards for ndev={ndev}")
    tune_malloc()
    a_sp = _fine_csr(a)

    levels = []
    host_ops = [a_sp]
    cur = a_sp
    while (cur.shape[0] > params.coarse_size
           and len(levels) < params.max_levels - 1):
        n = cur.shape[0]
        ranges = _shard_ranges(n, ndev)
        col, val, _ = ell_planes_from_scipy(cur, dtype=np.float32)

        mask = _strength_mask_ranges(col, val, params.theta, ranges)
        state = _pmis_distributed(col, mask, ranges,
                                  params.max_coarsen_rounds)
        is_c = state == hs.CPOINT
        nc = int(is_c.sum())
        if nc == 0 or n / max(nc, 1) < params.min_coarsen_factor:
            break
        # coarse numbering: per-shard counts and their prefix sum
        counts = [int(is_c[r0:r1].sum()) for (r0, r1) in ranges]
        offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
        cmap = np.zeros(n, np.int64)
        for (r0, r1), off in zip(ranges, offs):
            cmap[r0:r1] = off + np.cumsum(is_c[r0:r1]) - 1

        # ext+i per shard on compact ghost systems (global coarse ids go
        # straight into the kernel)
        kp = params.interp_max_elements
        p_col = np.zeros((n, kp), np.int32)
        p_val = np.zeros((n, kp), np.float32)
        for (r0, r1) in ranges:
            g2 = _ghost_ids(cur, r0, r1, 2)
            pc, pv = _extpi_shard(cur, r0, r1, g2, state, cmap, nc,
                                  params.theta, kp)
            p_col[r0:r1] = pc
            p_val[r0:r1] = pv
        p_sp = ell_planes_to_scipy(p_col, p_val.astype(np.float64), nc)
        p_sp = p_sp.tocsr()
        p_sp.sort_indices()
        lc = None
        if cache is not None:
            lc = dict(n=n, nc=nc, ranges=ranges, mask=mask, state=state,
                      cmap=cmap, counts=counts, offs=offs,
                      p_col=p_col.copy(), p_valid=p_val != 0,
                      a_pat=(cur.indptr.copy(), cur.indices.copy(),
                             int(cur.shape[1])),
                      shards=[])
            cache.levels.append(lc)

        # RAP per shard: the owned coarse rows by a shard-local Gustavson
        # product over the gathered A/P ghost rows; per row the
        # accumulation order is the serial native product's
        pt = p_sp.T.tocsr()
        pt.sort_indices()
        if lc is not None:
            # P-CSR → Pᵀ-CSR data permutation (the refresh derives Pᵀ's
            # values from P's without a transpose)
            tag = sp.csr_matrix(
                (np.arange(p_sp.nnz, dtype=np.int64), p_sp.indices,
                 p_sp.indptr), shape=p_sp.shape)
            lc["pt_perm"] = _i32(tag.T.tocsr().data)
            lc["pt_indptr"] = pt.indptr.copy()
        ac_rows = []
        for si, (r0, r1) in enumerate(ranges):
            c_lo, c_hi = int(offs[si]), int(offs[si]) + counts[si]
            if c_hi == c_lo:
                ac_rows.append(sp.csr_matrix((0, nc)))
                if lc is not None:
                    lc["shards"].append(None)
                continue
            pt_own = pt[c_lo:c_hi]
            ks = np.unique(pt_own.indices.astype(np.int64))
            a_rows = cur[ks]
            ap_rows = native.spgemm(a_rows, p_sp)      # rows = ks
            lk = np.full(n, -1, np.int64)
            lk[ks] = np.arange(len(ks))
            pt_l = sp.csr_matrix(
                (pt_own.data, lk[pt_own.indices], pt_own.indptr),
                shape=(c_hi - c_lo, len(ks)))
            acs = native.spgemm(pt_l, ap_rows)
            ac_rows.append(acs)
            if lc is not None:
                # data positions of cur[ks] inside cur.data (CSR row
                # slicing concatenates the row segments in ks order)
                lo = cur.indptr[ks]
                ln = (cur.indptr[ks + 1] - lo).astype(np.int64)
                a_sel = _i32(np.arange(int(ln.sum()), dtype=np.int64)
                             - np.repeat(np.cumsum(ln) - ln, ln)
                             + np.repeat(lo.astype(np.int64), ln))

                def pat(m):
                    return (m.indptr.copy(), m.indices.copy(),
                            int(m.shape[1]))
                lc["shards"].append(dict(
                    ks=ks, a_sel=a_sel, c_lo=c_lo, c_hi=c_hi,
                    a_pat=pat(a_rows), ap_pat=pat(ap_rows),
                    ptl_pat=pat(pt_l), acs_pat=pat(acs)))
        stacked = sp.vstack(ac_rows).tocsr()
        ac_sp = stacked.copy()
        ac_sp.sort_indices()
        ac_sp.eliminate_zeros()
        if lc is not None:
            # stacked per-shard structural rows → the final (zero-free)
            # A_c pattern: the keep map and the dropped positions
            st_rows = np.repeat(np.arange(stacked.shape[0], dtype=np.int64),
                                np.diff(stacked.indptr))
            st_keys = st_rows * nc + stacked.indices.astype(np.int64)
            ac_rows_idx = np.repeat(np.arange(ac_sp.shape[0],
                                              dtype=np.int64),
                                    np.diff(ac_sp.indptr))
            ac_keys = ac_rows_idx * nc + ac_sp.indices.astype(np.int64)
            keep = np.searchsorted(st_keys, ac_keys)
            if (keep >= len(st_keys)).any() or not np.array_equal(
                    st_keys[keep], ac_keys):
                raise AssertionError("dist cache: A_c pattern mismatch")
            drop_mask = np.ones(len(st_keys), bool)
            drop_mask[keep] = False
            lc["keep"] = _i32(keep)
            lc["dropped"] = _i32(np.flatnonzero(drop_mask))
            lc["ac_pat"] = (ac_sp.indptr.copy(), ac_sp.indices.copy(),
                            int(nc))

        dinv_np = _dinv(cur, params)
        lmax = _lmax_distributed(cur, dinv_np, ranges)
        levels.append(_host_level(cur, p_col, p_val, pt, dinv_np, lmax,
                                  state))
        host_ops.append(ac_sp)
        cur = ac_sp

    part_kw = dict(agg_rows_per_dev=agg_rows_per_dev, transport=transport)
    if cache is not None:
        cache.params = params
        cache.ndev = ndev
        cache.part_kw = part_kw
        cache.mesh = mesh
    return _finish(levels, cur, params, ndev, mesh, part_kw, host_ops,
                   keep_host)


def dist_pmis_refresh(a_new, cache: DistSetupCache, *,
                      verify_mask: bool = True, keep_host: bool = False):
    """Value-only rebuild of a cached per-shard PMIS hierarchy (the
    distributed form of :func:`..amg.refresh.amg_refresh`): the strength
    graphs, C/F splits, coarse numbering, interpolation patterns and every
    per-shard Galerkin pattern come from ``cache``; only values are
    recomputed, per shard, with the fresh setup's ghost-row semantics:

    - strength: each shard's mask from the new values, compared with the
      cache (``verify_mask``); drift raises :class:`PatternChangedError`;
    - ext+i: the per-shard numeric run on the compact ghost systems;
      near-tie truncation flips are repaired with the selection pinned to
      the cached pattern (``extpi_pinned_rows`` on the full-system planes,
      the serial refresh's semantics: partition-invariant, since ext+i
      reads only rows at distance ≤ 1); a pattern the repair cannot keep,
      or a repaired P whose nonzeros no longer match the cached transpose
      permutation (an exact-zero value), raises;
    - Galerkin: per-shard numeric-only products (``spgemm_numeric``) into
      the cached A·P and Pᵀ_l·(A·P) patterns, assembled through the cached
      keep map; a structurally eliminated entry above ``DROPPED_TOL`` of
      the largest raises;
    - Pᵀ's values come from P's through the cached permutation;
    - ``dinv`` and λmax: the canonical partition-invariant reductions.

    The result equals a fresh ``dist_pmis_setup`` of the new operator in
    structure, and in values to f32 roundoff; the partition is re-derived
    from the refreshed host values (the same geometry: the patterns are
    unchanged). ``keep_host=True`` returns ``(dh, DistHostSetup)``.
    """
    import scipy.sparse as sp

    from .. import native
    from ..amg.refresh import DROPPED_TOL, PatternChangedError
    from ..sparse.formats import ell_planes_from_scipy, ell_planes_to_scipy
    from ..utils.memtune import tune_malloc

    tune_malloc()
    if cache.params is None:
        raise ValueError("cache was not produced by dist_pmis_setup")
    params = cache.params
    a_sp = _fine_csr(a_new)

    levels = []
    host_ops = [a_sp]
    cur_data = np.ascontiguousarray(a_sp.data, np.float64)
    last = a_sp
    for li, lc in enumerate(cache.levels):
        ip, ix, ncols = lc["a_pat"]
        if li == 0:
            if (a_sp.shape != (len(ip) - 1, ncols)
                    or a_sp.nnz != len(ix)
                    or not np.array_equal(a_sp.indices, ix)
                    or not np.array_equal(a_sp.indptr, ip)):
                raise PatternChangedError("L0: CSR pattern changed")
        cur = sp.csr_matrix((cur_data, ix, ip), shape=(len(ip) - 1, ncols))
        cur.has_sorted_indices = True
        n, nc = lc["n"], lc["nc"]
        ranges = lc["ranges"]
        state, cmap = lc["state"], lc["cmap"]
        col, val, _ = ell_planes_from_scipy(cur, dtype=np.float32)
        if col.shape != lc["mask"].shape:
            raise PatternChangedError(f"L{li}: ELL width changed")
        if verify_mask:
            m2 = _strength_mask_ranges(col, val, params.theta, ranges)
            if not np.array_equal(m2, lc["mask"]):
                raise PatternChangedError(f"L{li}: strength mask changed")

        kp = params.interp_max_elements
        p_col = np.zeros((n, kp), np.int32)
        p_val = np.zeros((n, kp), np.float32)
        for (r0, r1) in ranges:
            g2 = _ghost_ids(cur, r0, r1, 2)
            pc, pv = _extpi_shard(cur, r0, r1, g2, state, cmap, nc,
                                  params.theta, kp)
            p_col[r0:r1] = pc
            p_val[r0:r1] = pv
        if not np.array_equal(p_col, lc["p_col"]) or not np.array_equal(
                p_val != 0, lc["p_valid"]):
            # near-tie truncation flips: recompute just those rows with
            # the selection pinned to the cached pattern (the serial
            # refresh's repair), on the full-system planes
            bad = np.flatnonzero((p_col != lc["p_col"]).any(axis=1)
                                 | ((p_val != 0)
                                    != lc["p_valid"]).any(axis=1))
            try:
                pv_rows = hs.extpi_pinned_rows(
                    col, val, lc["mask"], state, cmap, nc, bad,
                    lc["p_col"], lc["p_valid"])
            except ValueError as e:
                raise PatternChangedError(f"L{li}: {e}") from e
            p_col = lc["p_col"]
            p_val = p_val.copy()
            p_val[bad] = pv_rows
            p_val[~lc["p_valid"]] = 0
        p_sp = ell_planes_to_scipy(p_col, p_val.astype(np.float64), nc)
        p_sp = p_sp.tocsr()
        p_sp.sort_indices()
        if p_sp.nnz != len(lc["pt_perm"]):
            # an exact-zero P value dropped from the cached pattern: the
            # transpose permutation would misalign every later value
            raise PatternChangedError(
                f"L{li}: P has {p_sp.nnz} nonzeros, the cached pattern "
                f"{len(lc['pt_perm'])}")
        p_data = np.ascontiguousarray(p_sp.data, np.float64)
        pt_data = native.perm_gather(lc["pt_perm"], p_data)
        pt_indptr = lc["pt_indptr"]

        # per-shard Galerkin numeric phase into the cached patterns
        acs_vals = []
        for sh in lc["shards"]:
            if sh is None:
                continue
            a_rows_data = native.perm_gather(sh["a_sel"], cur_data)
            ap_val = native.spgemm_numeric(sh["a_pat"], a_rows_data,
                                           (p_sp.indptr, p_sp.indices, nc),
                                           p_data, sh["ap_pat"])
            ptl_data = pt_data[pt_indptr[sh["c_lo"]]:pt_indptr[sh["c_hi"]]]
            acs_vals.append(native.spgemm_numeric(
                sh["ptl_pat"], ptl_data, sh["ap_pat"], ap_val,
                sh["acs_pat"]))
        stacked = (np.concatenate(acs_vals) if acs_vals
                   else np.zeros(0, np.float64))
        dropped = lc["dropped"]
        if len(dropped):
            scale = np.abs(stacked).max() if len(stacked) else 1.0
            # the f32 residue of setup-cancelled entries is ~1.4e-8 of the
            # scale; drift above DROPPED_TOL is a real pattern change
            if np.abs(stacked[dropped]).max() > DROPPED_TOL * max(scale,
                                                                  1e-300):
                raise PatternChangedError(
                    f"L{li}: Galerkin entry eliminated at setup became "
                    "nonzero")
        ac_data = native.perm_gather(lc["keep"], stacked)

        dinv_np = _dinv(cur, params)
        lmax = _lmax_distributed(cur, dinv_np, ranges)
        pt = sp.csr_matrix((pt_data, *_pt_pattern_of(p_sp)), shape=(nc, n))
        levels.append(_host_level(cur, p_col, p_val, pt, dinv_np, lmax,
                                  state))
        cur_data = ac_data
        ac_ip, ac_ix, _ = lc["ac_pat"]
        last = sp.csr_matrix((ac_data, ac_ix, ac_ip), shape=(nc, nc))
        host_ops.append(last)

    return _finish(levels, last, params, cache.ndev, cache.mesh,
                   cache.part_kw, host_ops, keep_host)


def _pt_pattern_of(p_sp):
    """(indices, indptr) of Pᵀ in CSR: the structural transpose only (the
    values come from the cached permutation); scipy's ``.T.tocsr()`` of a
    pattern copy gives the fresh setup's order."""
    import scipy.sparse as sp

    tag = sp.csr_matrix((np.ones(p_sp.nnz), p_sp.indices, p_sp.indptr),
                        shape=p_sp.shape)
    pt = tag.T.tocsr()
    pt.sort_indices()
    return pt.indices, pt.indptr


def _lmax_distributed(a_csr, dinv, ranges, iters: int = 20):
    """Power iteration: shard-local products (ghost x) and canonical
    reductions."""
    n = a_csr.shape[0]
    v = hs.hash01_np(np.arange(n)).astype(np.float64) - 0.5
    v = v / _canon_norm(v)

    def apply(v):
        w = np.empty(n, np.float64)
        for (r0, r1) in ranges:
            w[r0:r1] = dinv[r0:r1] * (a_csr[r0:r1] @ v)
        return w

    for _ in range(iters):
        w = apply(v)
        v = w / _canon_norm(w)
    w = apply(v)
    return _canon_sum(v * w) / _canon_sum(v * v)
