"""ctypes bindings for the host setup kernels of ``csrc/native.cc``.

Counterpart of ``omp_amg_tpu/native.py``, cut to the entry points the PMIS
host setup calls: ``strength_mask``, ``pmis``, ``extpi_interp``, ``spgemm``,
``CsrMatvec`` and ``ell_fill``. numpy only. The library is built on first use
by :mod:`omp_amg_tpu_torch._build` (never the committed
``csrc/libamgnative.so``). As in the reference, each entry point returns
None (``spgemm`` and ``CsrMatvec`` run scipy) when the library could not be
built, and the callers in :mod:`omp_amg_tpu_torch.amg.host_setup` then run
their numpy twins; ``available()`` says which ran and ``build_error()`` why.
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
