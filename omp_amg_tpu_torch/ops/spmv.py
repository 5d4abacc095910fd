"""Sparse matrix–vector products: dispatch by operator format.

Counterpart of ``omp_amg_tpu/ops/spmv.py`` (``spmv``, ``residual``): a
banded ``Dia`` goes to the DIA kernel (:mod:`.dia_spmv`), a ``Csr`` to the
CSR kernel (:mod:`.csr_spmv`). The fused residual and Jacobi epilogues are
dispatched the same way.
"""

from __future__ import annotations

import torch

from ..sparse.formats import Csr, Dia
from . import csr_spmv, dia_spmv


def _kernel_module(a):
    if isinstance(a, Dia):
        return dia_spmv
    if isinstance(a, Csr):
        return csr_spmv
    raise TypeError(f"unsupported operator {type(a).__name__}")


def spmv(a, x: torch.Tensor) -> torch.Tensor:
    """y = A·x."""
    return _kernel_module(a).spmv(a, x)


def residual(a, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """r = b − A·x, fused into the SpMV pass."""
    return _kernel_module(a).residual(a, x, b)


def jacobi(a, x: torch.Tensor, b: torch.Tensor,
           s: torch.Tensor) -> torch.Tensor:
    """One weighted-Jacobi sweep x + s ⊙ (b − A·x), fused into the SpMV
    pass (s = ω·D⁻¹ per row)."""
    return _kernel_module(a).jacobi(a, x, b, s)
