"""ctypes bindings for the host setup kernels of ``csrc/native.cc``.

Counterpart of ``omp_amg_tpu/native.py``, cut to the entry points the host
setups call: ``strength_mask``, ``pmis``, ``extpi_interp``, ``spgemm``,
``CsrMatvec`` and ``ell_fill`` (PMIS); ``d2_color_wide`` (the port's own
uncapped colouring, ``omp_amg_tpu_torch/csrc/d2_color.cc``, built into the
same library, for ``AMGParams(rap="probe")``); ``dia_apply``, ``prolong``,
``restrict`` and ``rap_stencil`` (structured); ``spgemm_numeric`` and
``perm_gather`` (the value-only refresh, :mod:`.amg.refresh`).
``d2_color`` binds native.cc's colouring, capped at 256 colours, which the
tests hold the wide one to. numpy only. The library is built on first use
by :mod:`omp_amg_tpu_torch._build` (never the committed
``csrc/libamgnative.so``). As in the reference, each entry point returns
None, or runs its numpy twin, when the library could not be built;
``available()`` says which ran and ``build_error()`` why.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import _build

_lib = None
_tried = False
_error: Exception | None = None


def _load():
    global _lib, _tried, _error
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(_build.native_library()))
    except (OSError, RuntimeError) as e:
        _error = e
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C")
    i64 = ctypes.c_int64
    lib.spgemm_row_nnz.argtypes = [i64, i64, i64p, i32p, i64p, i32p, i64p]
    lib.spgemm_row_nnz.restype = None
    lib.spgemm_fill.argtypes = [i64, i64, i64p, i32p, f64p, i64p, i32p, f64p,
                                i64p, i32p, f64p]
    lib.spgemm_fill.restype = None
    lib.spgemm_numeric.argtypes = [i64, i64, i64p, i32p, f64p, i64p, i32p,
                                   f64p, i64p, i32p, f64p]
    lib.spgemm_numeric.restype = None
    lib.perm_gather_f64.argtypes = [i64, i64p, f64p, f64p]
    lib.perm_gather_f64.restype = None
    lib.perm_gather_f64_i32.argtypes = [i64, i32p, f64p, f64p]
    lib.perm_gather_f64_i32.restype = None
    lib.csr_matvec_f64.argtypes = [i64, i64p, i32p, f64p, f64p, f64p]
    lib.csr_matvec_f64.restype = None
    lib.extpi_interp_f64.argtypes = [i64, i64, i64, i32p, f64p, u8p, i8p,
                                     i64p, i64, i32p, f64p]
    lib.extpi_interp_f64.restype = None
    lib.extpi_interp_f32v.argtypes = [i64, i64, i64, i32p, f32p, u8p, i8p,
                                      i64p, i64, i32p, f64p]
    lib.extpi_interp_f32v.restype = None
    lib.strength_mask_f32.argtypes = [i64, i64, i32p, f32p, ctypes.c_double,
                                      u8p]
    lib.strength_mask_f32.restype = None
    lib.pmis_f32.argtypes = [i64, i64, i32p, u8p, i64, i32p]
    lib.pmis_f32.restype = i64
    lib.ell_fill_f32.argtypes = [i64, i64, i64p, i32p, f64p, i32p, f32p]
    lib.ell_fill_f32.restype = None
    lib.dia_apply_f64.argtypes = [i64, i64, i64p, f64p, f64p, f64p]
    lib.dia_apply_f64.restype = None
    lib.dia_apply_f32.argtypes = [i64, i64, i64p, f32p, f32p, f32p]
    lib.dia_apply_f32.restype = None
    lib.prolong_last_f64.argtypes = [i64, i64, i64, f64p, f64p]
    lib.prolong_last_f64.restype = None
    lib.restrict_last_f64.argtypes = [i64, i64, i64, f64p, f64p]
    lib.restrict_last_f64.restype = None
    lib.rap_stencil_f64.argtypes = [i64, i64p, i64p, i64p, i64, i64p, i64p,
                                    f64p, f64p]
    lib.rap_stencil_f64.restype = None
    lib.d2_color_greedy.argtypes = [i64, i64, i64p, i32p, i64p, i32p, i32p]
    lib.d2_color_greedy.restype = i64
    lib.d2_color_greedy_wide.argtypes = [i64, i64, i64p, i32p, i64, i32p]
    lib.d2_color_greedy_wide.restype = i64
    _lib = lib
    return _lib


def available() -> bool:
    """True when the native library is loaded (else the numpy twins run)."""
    return _load() is not None


def build_error() -> Exception | None:
    """Why the native library is unavailable (None when it loaded)."""
    _load()
    return _error


def strength_mask(col: np.ndarray, val: np.ndarray, theta: float):
    """Native strength-of-connection mask; None when the lib is missing."""
    lib = _load()
    if lib is None:
        return None
    n, k = col.shape
    mask = np.empty((n, k), np.uint8)
    lib.strength_mask_f32(n, k, np.ascontiguousarray(col, np.int32),
                          np.ascontiguousarray(val, np.float32),
                          float(theta), mask.reshape(-1))
    return mask.astype(bool)


def pmis(col: np.ndarray, mask: np.ndarray, max_rounds: int = 64):
    """Native PMIS C/F split (bit-identical to host_setup.pmis_np); None
    when the lib is missing."""
    lib = _load()
    if lib is None:
        return None
    n, k = col.shape
    state = np.empty(n, np.int32)
    rounds = lib.pmis_f32(n, k, np.ascontiguousarray(col, np.int32),
                          np.ascontiguousarray(mask, np.uint8),
                          int(max_rounds), state)
    if rounds < 0:
        raise RuntimeError("PMIS did not terminate")
    return state


def extpi_interp(col, val, mask, state, cmap, n_coarse,
                 max_elements: int = 6):
    """Native OpenMP extended+i interpolation over padded ELL planes.

    Returns (p_col i32, p_val f64) planes of width ``max_elements``, or None
    when the native library is unavailable (caller falls back to
    ``host_setup.extpi_interpolation_np``).
    """
    lib = _load()
    if lib is None:
        return None
    n, k = col.shape
    p_col = np.zeros((n, max_elements), np.int32)
    p_val = np.zeros((n, max_elements), np.float64)
    args = (n, k, int(n_coarse), np.ascontiguousarray(col, np.int32))
    tail = (np.ascontiguousarray(mask, np.uint8),
            np.ascontiguousarray(state, np.int8),
            np.ascontiguousarray(cmap, np.int64),
            int(max_elements), p_col, p_val)
    if np.asarray(val).dtype == np.float32:
        # f32-plane entry: every term converts exactly inside the kernel,
        # so the result equals the f64 entry on upcast planes
        lib.extpi_interp_f32v(*args, np.ascontiguousarray(val, np.float32),
                              *tail)
    else:
        lib.extpi_interp_f64(*args, np.ascontiguousarray(val, np.float64),
                             *tail)
    return p_col, p_val


def d2_color(m):
    """Distance-2 greedy column colouring of a scipy sparse matrix (columns
    in ascending order, per-row colour bitmasks, lowest free colour).

    Returns (colours int32 over the columns, n_colours), or None when the
    library is unavailable or more than 256 colours would be needed.
    """
    import scipy.sparse as sp

    lib = _load()
    if lib is None:
        return None
    csr = sp.csr_matrix(m)
    csc = csr.tocsc()
    colors = np.empty(csr.shape[1], np.int32)
    nc = lib.d2_color_greedy(
        csr.shape[0], csr.shape[1],
        np.ascontiguousarray(csr.indptr, np.int64),
        np.ascontiguousarray(csr.indices, np.int32),
        np.ascontiguousarray(csc.indptr, np.int64),
        np.ascontiguousarray(csc.indices, np.int32), colors)
    if nc < 0:
        return None
    return colors, int(nc)


def d2_color_wide(m):
    """The same colouring as :func:`d2_color` with no cap on the colours
    (``csrc/d2_color.cc``: the masks start as wide as the longest row needs
    and widen on demand). Returns (colours int32 over the columns,
    n_colours), or None when the library is unavailable."""
    import scipy.sparse as sp

    lib = _load()
    if lib is None:
        return None
    csc = sp.csc_matrix(m)
    n_rows, n_cols = csc.shape
    longest = int(np.bincount(csc.indices, minlength=n_rows).max()) \
        if csc.nnz else 0
    colors = np.empty(n_cols, np.int32)
    nc = lib.d2_color_greedy_wide(
        n_rows, n_cols, np.ascontiguousarray(csc.indptr, np.int64),
        np.ascontiguousarray(csc.indices, np.int32), max(1, -(-longest // 64)),
        colors)
    return colors, int(nc)


def spgemm(a, b):
    """C = A @ B for scipy CSR matrices via the native Gustavson kernels
    (scipy's product when the library is missing)."""
    import scipy.sparse as sp

    lib = _load()
    if lib is None:
        return (sp.csr_matrix(a) @ sp.csr_matrix(b)).tocsr()
    a = sp.csr_matrix(a)
    b = sp.csr_matrix(b)
    n, m = a.shape[0], b.shape[1]
    a_indptr = np.ascontiguousarray(a.indptr, np.int64)
    b_indptr = np.ascontiguousarray(b.indptr, np.int64)
    a_idx = np.ascontiguousarray(a.indices, np.int32)
    b_idx = np.ascontiguousarray(b.indices, np.int32)
    a_val = np.ascontiguousarray(a.data, np.float64)
    b_val = np.ascontiguousarray(b.data, np.float64)
    row_nnz = np.empty(n, np.int64)
    lib.spgemm_row_nnz(n, m, a_indptr, a_idx, b_indptr, b_idx, row_nnz)
    c_indptr = np.zeros(n + 1, np.int64)
    np.cumsum(row_nnz, out=c_indptr[1:])
    nnz = int(c_indptr[-1])
    c_idx = np.empty(nnz, np.int32)
    c_val = np.empty(nnz, np.float64)
    lib.spgemm_fill(n, m, a_indptr, a_idx, a_val, b_indptr, b_idx, b_val,
                    c_indptr, c_idx, c_val)
    return sp.csr_matrix((c_val, c_idx, c_indptr), shape=(n, m))


def csr_flat_keys(indptr, indices, n_cols) -> np.ndarray:
    """row·n_cols + column of every entry of a CSR pattern (int64)."""
    rows = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64),
                     np.diff(indptr))
    return rows * int(n_cols) + np.asarray(indices, np.int64)


def check_spgemm_containment(a_pat, b_pat, c_pat) -> None:
    """Raise ValueError unless the structural pattern of A·B lies inside
    ``c_pat`` (``spgemm_numeric``'s precondition; patterns are (indptr,
    indices, n_cols) triples with sorted rows). One structural product:
    for tests and debugging."""
    import scipy.sparse as sp

    a_indptr, a_idx, _ = a_pat
    b_indptr, b_idx, b_ncols = b_pat
    c_indptr, c_idx, _ = c_pat
    n = len(a_indptr) - 1
    a = sp.csr_matrix((np.ones(len(a_idx)), a_idx, a_indptr),
                      shape=(n, len(b_indptr) - 1))
    b = sp.csr_matrix((np.ones(len(b_idx)), b_idx, b_indptr),
                      shape=(len(b_indptr) - 1, b_ncols))
    s = (a @ b).tocsr()
    s.sort_indices()
    keys_s = csr_flat_keys(s.indptr, s.indices, b_ncols)
    keys_c = csr_flat_keys(c_indptr, c_idx, b_ncols)
    pos = np.searchsorted(keys_c, keys_s)
    if (pos >= len(keys_c)).any() or not np.array_equal(keys_c[pos], keys_s):
        raise ValueError(
            "spgemm_numeric: the structural A·B pattern is not contained in "
            "the cached output pattern; the values would be silently wrong")


def spgemm_numeric(a_pat, a_data, b_pat, b_data, c_pat,
                   check: bool = False) -> np.ndarray:
    """Numeric-only C = A·B into a cached output pattern; returns C's
    values (f64) in ``c_pat``'s order.

    ``*_pat`` are (indptr int64, indices int32, n_cols) triples. The caller
    guarantees that every structural product term A[i, k]·B[k, j] lands
    inside ``c_pat``: the native kernel clears its dense row accumulator
    only at the cached positions, so an uncovered column would leak its
    partial sum into later rows, silently. ``check=True`` verifies that
    first (:func:`check_spgemm_containment`: one structural product, slow).
    Positions the values cancel at hold 0. Without the library, scipy's
    product scattered into the pattern.
    """
    if check:
        check_spgemm_containment(a_pat, b_pat, c_pat)
    a_indptr, a_idx, _ = a_pat
    b_indptr, b_idx, b_ncols = b_pat
    c_indptr, c_idx, _ = c_pat
    n = len(a_indptr) - 1
    a_data = np.ascontiguousarray(a_data, np.float64)
    b_data = np.ascontiguousarray(b_data, np.float64)
    if (len(a_data) != len(a_idx) or len(b_data) != len(b_idx)
            or a_pat[2] != len(b_indptr) - 1
            or len(c_indptr) != len(a_indptr)):
        raise ValueError("spgemm_numeric: pattern and value sizes disagree")
    lib = _load()
    c_val = np.empty(len(c_idx), np.float64)
    if lib is None:
        import scipy.sparse as sp

        a = sp.csr_matrix((a_data, a_idx, a_indptr),
                          shape=(n, len(b_indptr) - 1))
        b = sp.csr_matrix((b_data, b_idx, b_indptr),
                          shape=(len(b_indptr) - 1, b_ncols))
        c = (a @ b).tocsr()
        c.sort_indices()
        c_val[:] = 0.0
        pos = np.searchsorted(csr_flat_keys(c_indptr, c_idx, b_ncols),
                              csr_flat_keys(c.indptr, c.indices, b_ncols))
        c_val[pos] = c.data
        return c_val
    lib.spgemm_numeric(n, b_ncols,
                       np.ascontiguousarray(a_indptr, np.int64),
                       np.ascontiguousarray(a_idx, np.int32), a_data,
                       np.ascontiguousarray(b_indptr, np.int64),
                       np.ascontiguousarray(b_idx, np.int32), b_data,
                       np.ascontiguousarray(c_indptr, np.int64),
                       np.ascontiguousarray(c_idx, np.int32), c_val)
    return c_val


def perm_gather(perm: np.ndarray, x: np.ndarray) -> np.ndarray:
    """out[i] = x[perm[i]] in f64, threaded (an int32 ``perm`` takes the
    int32 kernel, so the refresh cache's int32 maps are not widened per
    call); numpy indexing without the library. Indices are checked against
    ``x`` first: the kernel reads without bounds checks."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float64)
    perm = np.asarray(perm)
    if len(perm) and (int(perm.min()) < 0 or int(perm.max()) >= len(x)):
        raise IndexError("perm_gather: index out of range")
    if lib is None:
        return x[perm]
    out = np.empty(len(perm), np.float64)
    if perm.dtype == np.int32:
        lib.perm_gather_f64_i32(len(perm), np.ascontiguousarray(perm), x,
                                out)
    else:
        lib.perm_gather_f64(len(perm),
                            np.ascontiguousarray(perm, np.int64), x, out)
    return out


class CsrMatvec:
    """Reusable threaded f64 CSR matvec (native; scipy fallback).

    Keeps the contiguous int64/int32 pattern copies across calls, so the
    λmax power iteration and the certified outer residual pay the ctypes
    marshalling once. Per-row accumulation order equals scipy's csr_matvec.
    """

    def __init__(self, indptr, indices, data, n_cols=None):
        self.lib = _load()
        self.n = len(indptr) - 1
        self.data = np.ascontiguousarray(data, np.float64)
        if self.lib is None:
            import scipy.sparse as sp

            self.sp = sp.csr_matrix(
                (self.data, indices, indptr),
                shape=(self.n, n_cols if n_cols is not None else self.n))
        else:
            self.indptr = np.ascontiguousarray(indptr, np.int64)
            self.indices = np.ascontiguousarray(indices, np.int32)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        if self.lib is None:
            return self.sp @ x
        y = np.empty(self.n, np.float64)
        self.lib.csr_matvec_f64(self.n, self.indptr, self.indices, self.data,
                                np.ascontiguousarray(x, np.float64), y)
        return y


def dia_apply(offsets, data: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Banded matvec (data[k, i] multiplies x[i + offsets[k]]); f32 operands
    stay f32. numpy twin when the lib is missing."""
    lib = _load()
    if lib is None:
        from .amg.comb_rap import dia_apply as np_apply

        return np_apply(list(offsets), data, x)
    n = x.shape[0]
    offs = np.ascontiguousarray(offsets, np.int64)
    if data.dtype == np.float32:
        y = np.empty(n, np.float32)
        lib.dia_apply_f32(n, len(offsets), offs,
                          np.ascontiguousarray(data, np.float32),
                          np.ascontiguousarray(x, np.float32), y)
        return y
    y = np.empty(n, np.float64)
    lib.dia_apply_f64(n, len(offsets), offs,
                      np.ascontiguousarray(data, np.float64),
                      np.ascontiguousarray(x, np.float64), y)
    return y


def _apply_axis(x: np.ndarray, axis: int, fn, n_out: int) -> np.ndarray:
    """Apply a last-axis kernel along ``axis`` of a C-order ndarray."""
    moved = np.ascontiguousarray(np.moveaxis(x, axis, -1), np.float64)
    rows = int(np.prod(moved.shape[:-1], dtype=np.int64))
    n_in = moved.shape[-1]
    out = np.empty(moved.shape[:-1] + (n_out,), np.float64)
    fn(rows, n_in, n_out, moved.reshape(rows, n_in), out.reshape(rows, n_out))
    return np.moveaxis(out, -1, axis)


def prolong(xc: np.ndarray, fine_shape, coarse_shape, coarsened):
    """f64 tensor-product linear interpolation, coarse → fine grid."""
    lib = _load()
    if lib is None:
        from .amg.comb_rap import prolong as np_prolong

        return np_prolong(xc, fine_shape, coarse_shape, coarsened)
    x = xc.reshape(coarse_shape)
    for ax, c in enumerate(coarsened):
        if c:
            x = _apply_axis(x, ax, lib.prolong_last_f64, fine_shape[ax])
    return x.reshape(-1)


def restrict(xf: np.ndarray, fine_shape, coarse_shape, coarsened):
    """f64 transpose of :func:`prolong`, fine → coarse grid."""
    lib = _load()
    if lib is None:
        from .amg.comb_rap import restrict as np_restrict

        return np_restrict(xf, fine_shape, coarse_shape, coarsened)
    x = xf.reshape(fine_shape)
    for ax, c in enumerate(coarsened):
        if c:
            x = _apply_axis(x, ax, lib.restrict_last_f64, coarse_shape[ax])
    return x.reshape(-1)


def rap_stencil(offsets, data: np.ndarray, dims, coarse_dims, coarsened):
    """Fused direct Galerkin RAP of a radius-1 banded operator (csrc
    ``rap_stencil_f64``). Returns (offsets_c sorted, data_c (k, nc)) with
    all-zero taps dropped, or None when the lib is missing or an offset does
    not decompose on the grid."""
    from itertools import product as iproduct

    from .amg.comb_rap import _balanced_deltas
    from .amg.structured import grid_strides

    lib = _load()
    if lib is None:
        return None
    d = len(dims)
    nc = int(np.prod(coarse_dims, dtype=np.int64))
    # balanced per-axis decomposition of each offset (valid because the
    # masked-zero invariant keeps every stored tap non-wrapping)
    deltas = _balanced_deltas(offsets, dims)
    if deltas is None:
        return None
    out = np.zeros((3 ** d) * nc, np.float64)
    lib.rap_stencil_f64(
        d, np.ascontiguousarray(dims, np.int64),
        np.ascontiguousarray(coarse_dims, np.int64),
        np.ascontiguousarray([1 if c else 0 for c in coarsened], np.int64),
        len(offsets), np.ascontiguousarray(offsets, np.int64),
        np.ascontiguousarray(deltas.ravel(), np.int64),
        np.ascontiguousarray(data, np.float64), out)
    out = out.reshape(3 ** d, nc)
    cstrides = grid_strides(coarse_dims)
    entries = []
    for ti, delta in enumerate(iproduct((-1, 0, 1), repeat=d)):
        if any(abs(dl) >= cd for dl, cd in zip(delta, coarse_dims)):
            continue
        if not np.any(out[ti]):
            continue
        entries.append((sum(dl * st for dl, st in zip(delta, cstrides)),
                        out[ti]))
    entries.sort(key=lambda e: e[0])
    offs_c = [e[0] for e in entries]
    data_c = np.stack([e[1] for e in entries]) if entries else out[:0]
    return offs_c, data_c


def ell_fill(a_csr, k: int):
    """CSR → zero-padded (col int32, val f32) ELL planes via the parallel
    native fill; None when the lib is missing (numpy fallback)."""
    lib = _load()
    if lib is None:
        return None
    n = a_csr.shape[0]
    col = np.zeros((n, max(k, 1)), np.int32)
    val = np.zeros((n, max(k, 1)), np.float32)
    lib.ell_fill_f32(n, max(k, 1),
                     np.ascontiguousarray(a_csr.indptr, np.int64),
                     np.ascontiguousarray(a_csr.indices, np.int32),
                     np.ascontiguousarray(a_csr.data, np.float64),
                     col.reshape(-1), val.reshape(-1))
    return col, val
