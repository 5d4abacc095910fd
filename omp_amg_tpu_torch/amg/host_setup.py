"""Vectorized numpy setup kernels of the classical (PMIS) host setup.

Counterpart of ``omp_amg_tpu/amg/host_setup.py`` (``hash01_np``, strength,
PMIS and the direct, standard and ext+i interpolations), unchanged in
substance: the port's setup runs the same host code, so its hierarchy equals
the reference's. The strength mask, PMIS and ext+i run the native OpenMP
kernels of ``csrc/native.cc`` when they are built (bit-identical, pinned in
the reference's tests), the numpy twins below otherwise.
"""

from __future__ import annotations

import numpy as np

UNDECIDED, CPOINT, FPOINT = 0, 1, 2


def hash01_np(idx) -> np.ndarray:
    x = np.asarray(idx, dtype=np.uint32)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
        x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
        x = x ^ (x >> np.uint32(16))
    return (x >> np.uint32(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))


def strength_mask_host(col: np.ndarray, val: np.ndarray,
                       theta: float) -> np.ndarray:
    """Strength mask via the native OpenMP kernel when built (bit-identical
    to :func:`strength_mask_np` — pinned in tests), numpy otherwise."""
    from .. import native

    out = native.strength_mask(col, val, theta)
    return strength_mask_np(col, val, theta) if out is None else out


def pmis_host(col: np.ndarray, mask: np.ndarray,
              max_rounds: int = 64) -> np.ndarray:
    """PMIS C/F split via the native OpenMP rounds when built (bit-identical
    to :func:`pmis_np` — every reduction is an order-free max/any, weights
    are the same lowbias32 hash), numpy otherwise."""
    from .. import native

    out = native.pmis(col, mask, max_rounds)
    return pmis_np(col, mask, max_rounds) if out is None else out


def strength_mask_np(col: np.ndarray, val: np.ndarray, theta: float) -> np.ndarray:
    """Boolean (n, K) strong-dependency mask (classical strength)."""
    n = col.shape[0]
    rows = np.arange(n, dtype=col.dtype)[:, None]
    is_diag = col == rows
    is_pad = val == 0
    offdiag = ~is_diag & ~is_pad
    diag = np.where(is_diag, val, 0).sum(axis=1, keepdims=True)
    sign = np.where(diag >= 0, 1.0, -1.0).astype(val.dtype)
    s = np.where(offdiag, -sign * val, 0)
    row_max = s.max(axis=1, keepdims=True)
    return offdiag & (s > 0) & (s >= theta * row_max) & (row_max > 0)


def _sym_adjacency(col: np.ndarray, mask: np.ndarray):
    """Symmetrized strength adjacency S ∪ S^T as padded ELL (gather-only PMIS).

    Returns (adj, valid): adj (n, K2) neighbor ids (self-padded), valid mask.
    """
    import scipy.sparse as sp

    n = col.shape[0]
    k = col.shape[1]
    rows = (np.arange(n, dtype=np.int32)[:, None] * np.ones((1, k), np.int32))
    r = rows[mask]
    c = col[mask]
    s = sp.csr_matrix((np.ones(len(r), np.int8), (r, c)), shape=(n, n))
    sym = (s + s.T).tocsr()  # entries 1/2; diagonal absent (mask excludes it)
    lengths = np.diff(sym.indptr)
    k2 = max(int(lengths.max(initial=0)), 1)
    adj = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, k2))  # self-pad
    pos = np.arange(sym.nnz, dtype=np.int64) - np.repeat(
        sym.indptr[:-1].astype(np.int64), lengths)
    rr = np.repeat(np.arange(n, dtype=np.int64), lengths)
    adj[rr, pos] = sym.indices
    valid = np.zeros((n, k2), dtype=bool)
    valid[rr, pos] = True
    return adj, valid


def pmis_np(col: np.ndarray, mask: np.ndarray, max_rounds: int = 64) -> np.ndarray:
    """C/F split, bit-identical to the reference's device pmis."""
    n = col.shape[0]
    # influence count |S^T_i| (exact integer scatter via bincount)
    cnt = np.bincount(col[mask].ravel(), minlength=n).astype(np.int64)
    weight = cnt.astype(np.float32) + hash01_np(np.arange(n))

    adj, valid = _sym_adjacency(col, mask)
    state = np.zeros(n, np.int32)
    key = np.full(n, -1.0, np.float32)
    for _ in range(max_rounds):
        u = np.flatnonzero(state == UNDECIDED)
        if len(u) == 0:
            break
        # active-set rounds: only undecided rows do neighborhood reductions
        key[:] = -1.0
        key[u] = weight[u]
        adj_u, valid_u = adj[u], valid[u]
        kn = key[adj_u]
        kn[~valid_u] = -1.0
        nb_key = kn.max(axis=1, initial=-1.0)
        nb_idx = np.where(valid_u & (kn == nb_key[:, None]), adj_u, -1).max(
            axis=1, initial=-1)
        ku = weight[u]
        cand_u = (ku > nb_key) | ((ku == nb_key) & (u > nb_idx))
        cand = np.zeros(n, bool)
        cand[u[cand_u]] = True
        has_c_u = (cand[adj_u] & valid_u).any(axis=1)
        state[u[cand_u]] = CPOINT
        state[u[~cand_u & has_c_u]] = FPOINT
    else:
        raise RuntimeError("PMIS did not terminate")
    # promote stranded F-points (strong deps but none on a C-point)
    is_c = state == CPOINT
    dep_c = (mask & is_c[col]).any(axis=1)
    any_dep = mask.any(axis=1)
    return np.where((state == FPOINT) & any_dep & ~dep_c, CPOINT, state)


def direct_interpolation_np(col, val, mask, state, cmap, n_coarse):
    """P as ELL planes, as the reference's device direct_interpolation."""
    n, k = col.shape
    rows = np.arange(n, dtype=col.dtype)[:, None]
    is_diag = col == rows
    is_c = state == CPOINT

    # boolean-multiply formulation (cheaper than np.where chains), f32 math
    diag = (val * is_diag).sum(axis=1)
    neg = val < 0          # diagonal is positive for our SPD targets; even if
    pos = (val > 0) & ~is_diag  # not, is_diag excl. keeps it out of `pos`
    neg &= ~is_diag
    sum_neg = (val * neg).sum(axis=1)
    sum_pos = (val * pos).sum(axis=1)
    strong_c = mask & is_c[col]
    sum_c_neg = (val * (strong_c & neg)).sum(axis=1)
    sum_c_pos = (val * (strong_c & pos)).sum(axis=1)

    alpha = np.where(sum_c_neg != 0,
                     sum_neg / np.where(sum_c_neg != 0, sum_c_neg, 1), 0)
    beta = np.where(sum_c_pos != 0,
                    sum_pos / np.where(sum_c_pos != 0, sum_c_pos, 1), 0)
    dtil = diag + sum_pos * (sum_c_pos == 0)
    scale = np.where(val < 0, alpha[:, None], beta[:, None])
    w = (-(1.0 / dtil))[:, None] * scale * val

    p_val = (w * strong_c).astype(val.dtype)
    p_col = np.where(strong_c, cmap[col], 0).astype(np.int32)
    # C-rows: identity in slot 0
    p_col[is_c] = 0
    p_val[is_c] = 0
    p_col[is_c, 0] = cmap[is_c]
    p_val[is_c, 0] = 1.0
    return p_col, p_val


def standard_interpolation_np(col, val, mask, state, cmap, n_coarse,
                              max_elements: int = 6):
    """Ruge–Stüben 'standard' interpolation (strong-F distribution).

    Strong F-neighbors k of an F-point i are eliminated by distributing
    e_k over k's own strong-C couplings (fractions of negative couplings),
    then the resulting C-couplings are scaled like classical interpolation
    with weak couplings lumped into the diagonal:

        N = A_sC + A_sF · P1,   w_i: = -N_i: / (a_ii + Σ_weak a_ik),

    where P1[k,j] = â_kj / Σ_j â_kj over k's strong-C set (â = negative
    part). Restores near-grid-independent convergence for PMIS coarsening
    (direct interpolation alone loses it — see PAPERS.md, De Sterck/Yang).
    Rows are truncated to ``max_elements`` entries with sign-class rescaling
    (hypre-style P_max) so the device ELL width stays bounded.
    """
    import scipy.sparse as sp

    from ..sparse.formats import ell_planes_to_scipy

    n, k = col.shape
    rows = np.arange(n, dtype=col.dtype)[:, None]
    is_diag = col == rows
    is_c = state == CPOINT
    is_f_col = (state == FPOINT)[col]

    diag = (val * is_diag).sum(axis=1)
    strong_c = mask & is_c[col]
    strong_f = mask & is_f_col
    weak = ~is_diag & ~strong_c & ~strong_f & (val != 0)

    # P1: distribution fractions over strong-C, negative couplings only
    neg = val < 0
    p1_num = val * (strong_c & neg)
    p1_den = p1_num.sum(axis=1)
    safe_den = np.where(p1_den != 0, p1_den, 1.0)
    p1_val = p1_num / safe_den[:, None]
    # strong-F neighbors whose own strong-C set is empty cannot distribute;
    # treat those couplings as weak (lump into the diagonal)
    can_distribute = (p1_den != 0)
    sf_ok = strong_f & can_distribute[col]
    weak = weak | (strong_f & ~sf_ok)

    # sparse assembly (host, setup phase): N = A_sC + A_sF_ok @ P1
    a_sc = ell_planes_to_scipy(np.where(strong_c, col, 0),
                               val * strong_c, n)
    a_sf = ell_planes_to_scipy(np.where(strong_f & sf_ok, col, 0),
                               val * (strong_f & sf_ok), n)
    p1 = ell_planes_to_scipy(np.where(strong_c & neg, col, 0), p1_val, n)
    from ..native import spgemm
    nmat = (a_sc + spgemm(a_sf, p1)).tocsr()
    nmat.sum_duplicates()
    # columns of N are C-points by construction: a_sc has strong-C columns;
    # a_sf @ p1 columns are the strong-C sets of F rows.

    dtil = diag + (val * weak).sum(axis=1)

    # per-row top-|max_elements| truncation with sign-class rescale
    lengths = np.diff(nmat.indptr)
    kmax = int(lengths.max(initial=1))
    ncol, nval, _ = _csr_to_padded(nmat, kmax)
    wmat = -nval / dtil[:, None]
    if kmax > max_elements:
        # stable: truncation ties keep the lowest column (matches the
        # native kernel's deterministic tie-break)
        order = np.argsort(-np.abs(wmat), axis=1,
                           kind="stable")[:, :max_elements]
        sel_col = np.take_along_axis(ncol, order, axis=1)
        sel_w = np.take_along_axis(wmat, order, axis=1)
        # rescale kept entries to preserve each sign-class row sum
        for sign in (1.0, -1.0):
            full = (wmat * (np.sign(wmat) == sign)).sum(axis=1)
            kept = (sel_w * (np.sign(sel_w) == sign)).sum(axis=1)
            fac = np.where(kept != 0, full / np.where(kept != 0, kept, 1), 1.0)
            sel_w = np.where(np.sign(sel_w) == sign, sel_w * fac[:, None],
                             sel_w)
        ncol, wmat = sel_col, sel_w

    p_col = np.where(wmat != 0, cmap[ncol], 0).astype(np.int32)
    p_val = wmat.astype(val.dtype) * (wmat != 0)
    is_c_row = is_c
    p_col[is_c_row] = 0
    p_val[is_c_row] = 0
    p_col[is_c_row, 0] = cmap[is_c_row]
    p_val[is_c_row, 0] = 1.0
    return p_col, p_val


def extpi_interpolation(col, val, mask, state, cmap, n_coarse,
                        max_elements: int = 6):
    """Ext+i interpolation: native OpenMP kernel when built (csrc/native.cc
    ``extpi_interp_f64`` — the setup-phase hot spot, ~20× the numpy twin),
    numpy fallback otherwise. Same formulas; values agree to f64 rounding."""
    from .. import native

    out = native.extpi_interp(col, val, mask, state,
                              np.asarray(cmap, np.int64), n_coarse,
                              max_elements)
    if out is not None:
        p_col, p_val = out
        return p_col, p_val.astype(np.asarray(val).dtype)
    return extpi_interpolation_np(col, val, mask, state, cmap, n_coarse,
                                  max_elements)


def extpi_interpolation_np(col, val, mask, state, cmap, n_coarse,
                           max_elements: int = 6):
    """Extended+i interpolation (distance-2 set, "+i" denominators).

    Like standard interpolation, strong-F neighbors k are eliminated by
    distributing their row over a C-set; extended+i distributes over
    C_k^s ∪ {i} — the fraction denominators include the connection back to
    the F-point i itself (the "+i" term, De Sterck/Yang/Heys; see
    PAPERS.md):

        d_ik = Σ_{l∈C_k^s} â_kl + â_ki
        N_i: = A_sC[i,:] + Σ_{k∈F_i^s} (a_ik / d_ik) · Â_sC[k,:]
        ᾱ_ii = a_ii + Σ_weak a_ik + Σ_{k∈F_i^s} a_ik â_ki / d_ik
        w_i: = -N_i: / ᾱ_ii

    (â = negative part). The interpolatory set is distance-2 (union of the
    strong-F neighbors' strong-C sets), which keeps convergence grid-
    independent under aggressive/PMIS coarsening while the row truncation
    bounds the ELL width. Columns are C-points by construction.
    """
    from ..native import spgemm
    from ..sparse.formats import ell_planes_to_scipy

    n, k = col.shape
    rows = np.arange(n, dtype=col.dtype)[:, None]
    is_diag = col == rows
    is_c = state == CPOINT
    is_f_col = (state == FPOINT)[col]

    diag = (val * is_diag).sum(axis=1)
    strong_c = mask & is_c[col]
    strong_f = mask & is_f_col
    weak = ~is_diag & ~strong_c & ~strong_f & (val != 0)

    neg = (val < 0) & ~is_diag
    aneg_strong_c = val * (strong_c & neg)
    d_base = aneg_strong_c.sum(axis=1)          # Σ_{l∈C_k^s} â_kl per row k

    # â_ki per ELL slot (i, k): transpose lookup on the negative part
    a_neg_sp = ell_planes_to_scipy(np.where(neg, col, 0), val * neg, n)
    a_neg_t = a_neg_sp.T.tocsr()
    rr = np.repeat(np.arange(n, dtype=np.int64), k)
    cc = np.asarray(col, np.int64).ravel()
    a_ki = np.asarray(a_neg_t[rr, cc]).reshape(n, k)

    d_ik = d_base[col] + a_ki                   # per (i, k) denominator
    ok = strong_f & (d_ik != 0)
    weak = weak | (strong_f & ~ok)
    b = np.where(ok, val / np.where(d_ik != 0, d_ik, 1.0), 0.0)

    a_sc = ell_planes_to_scipy(np.where(strong_c, col, 0), val * strong_c, n)
    b_sp = ell_planes_to_scipy(np.where(ok, col, 0), b, n)
    aneg_c_sp = ell_planes_to_scipy(np.where(strong_c & neg, col, 0),
                                    aneg_strong_c, n)
    nmat = (a_sc + spgemm(b_sp, aneg_c_sp)).tocsr()
    nmat.sum_duplicates()

    dtil = diag + (val * weak).sum(axis=1) + (b * a_ki * ok).sum(axis=1)

    lengths = np.diff(nmat.indptr)
    kmax = int(lengths.max(initial=1))
    ncol, nval, _ = _csr_to_padded(nmat, kmax)
    wmat = -nval / dtil[:, None]
    if kmax > max_elements:
        # stable: truncation ties keep the lowest column (matches the
        # native kernel's deterministic tie-break)
        order = np.argsort(-np.abs(wmat), axis=1,
                           kind="stable")[:, :max_elements]
        sel_col = np.take_along_axis(ncol, order, axis=1)
        sel_w = np.take_along_axis(wmat, order, axis=1)
        for sign in (1.0, -1.0):
            full = (wmat * (np.sign(wmat) == sign)).sum(axis=1)
            kept = (sel_w * (np.sign(sel_w) == sign)).sum(axis=1)
            fac = np.where(kept != 0, full / np.where(kept != 0, kept, 1), 1.0)
            sel_w = np.where(np.sign(sel_w) == sign, sel_w * fac[:, None],
                             sel_w)
        ncol, wmat = sel_col, sel_w

    p_col = np.where(wmat != 0, cmap[ncol], 0).astype(np.int32)
    p_val = wmat.astype(val.dtype) * (wmat != 0)
    p_col[is_c] = 0
    p_val[is_c] = 0
    p_col[is_c, 0] = cmap[is_c]
    p_val[is_c, 0] = 1.0
    return p_col, p_val


def _csr_to_padded(m, kmax):
    """CSR → padded (col, val) planes (col 0 / val 0 padding)."""
    n = m.shape[0]
    lengths = np.diff(m.indptr)
    col = np.zeros((n, max(kmax, 1)), np.int64)
    val = np.zeros((n, max(kmax, 1)), np.float64)
    pos = np.arange(m.nnz, dtype=np.int64) - np.repeat(
        m.indptr[:-1].astype(np.int64), lengths)
    rr = np.repeat(np.arange(n, dtype=np.int64), lengths)
    col[rr, pos] = m.indices
    val[rr, pos] = m.data
    return col, val, lengths
