"""Sparse matrix–vector products: dispatch by operator format.

Counterpart of ``omp_amg_tpu/ops/spmv.py`` (``spmv``, ``residual``): a
``ConstDia`` goes to the matrix-free stencil kernel (:mod:`.const_stencil`),
a banded ``Dia`` to the DIA kernel (:mod:`.dia_spmv`), a ``Csr`` to the CSR
kernel (:mod:`.csr_spmv`), and the structured grid transfers to their slice
forms (:mod:`..amg.structured`). The fused residual and Jacobi epilogues are
dispatched the same way; on a ``ConstDia`` the Jacobi scale ``s`` is one
float.
"""

from __future__ import annotations

import torch

from ..amg.structured import (
    GridProlong, GridRestrict, apply_prolong, apply_restrict,
)
from ..sparse.formats import ConstDia, Csr, Dia
from . import const_stencil, csr_spmv, dia_spmv


def _kernel_module(a):
    if isinstance(a, ConstDia):
        return const_stencil
    if isinstance(a, Dia):
        return dia_spmv
    if isinstance(a, Csr):
        return csr_spmv
    raise TypeError(f"unsupported operator {type(a).__name__}")


def spmv(a, x: torch.Tensor) -> torch.Tensor:
    """y = A·x."""
    if isinstance(a, GridProlong):
        return apply_prolong(a, x)
    if isinstance(a, GridRestrict):
        return apply_restrict(a, x)
    return _kernel_module(a).spmv(a, x)


def residual(a, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """r = b − A·x, fused into the SpMV pass."""
    return _kernel_module(a).residual(a, x, b)


def jacobi(a, x: torch.Tensor, b: torch.Tensor, s) -> torch.Tensor:
    """One weighted-Jacobi sweep x + s ⊙ (b − A·x), fused into the SpMV
    pass (s = ω·D⁻¹: a per-row tensor, or a float on a ``ConstDia``)."""
    return _kernel_module(a).jacobi(a, x, b, s)
