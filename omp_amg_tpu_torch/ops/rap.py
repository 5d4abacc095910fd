"""Galerkin triple product A_c = Pᵀ A P on the host (f64, setup phase).

Counterpart of ``omp_amg_tpu/ops/rap.py::galerkin_product``: the native
OpenMP Gustavson SpGEMM of ``csrc/native.cc`` when built, scipy otherwise.
"""

from __future__ import annotations

import numpy as np


def galerkin_product(a_sp, p_sp, pt_sp=None):
    """A_c = Pᵀ A P (scipy CSR, f64, zeros eliminated, indices sorted).

    ``pt_sp`` optionally supplies an already-computed Pᵀ in CSR form (the
    product casts data to f64 regardless, so an f32-valued transpose gives
    bit-identical results)."""
    import scipy.sparse as sp

    from ..native import available, spgemm

    a64 = sp.csr_matrix(a_sp, dtype=np.float64)
    p64 = sp.csr_matrix(p_sp, dtype=np.float64)
    if available():
        pt = pt_sp if pt_sp is not None else p64.T.tocsr()
        ac = spgemm(pt, spgemm(a64, p64))
    else:
        ac = (p64.T @ a64 @ p64).tocsr()
        ac.sum_duplicates()
    ac.eliminate_zeros()
    ac.sort_indices()
    return ac
