"""Sparse matrix–vector products: dispatch by operator format.

Counterpart of ``omp_amg_tpu/ops/spmv.py`` (``spmv``, ``residual``): a
``ConstDia`` goes to the matrix-free stencil kernel (:mod:`.const_stencil`),
a banded ``Dia`` to the DIA kernel (:mod:`.dia_spmv`), a ``Csr`` to the CSR
kernel (:mod:`.csr_spmv`), a ``TileCsr`` (the tiled form of the long-row
PMIS operators) to the tiled-CSR kernel (:mod:`.tile_csr`), and the
structured grid transfers (``GridProlong``, ``GridRestrict``) to the
grid-transfer kernel (:mod:`.grid_transfer`) on CUDA tensors; the per-axis slice forms of
:mod:`..amg.structured` are that kernel's plain twin, which CPU tensors
run. The fused residual and Jacobi epilogues are
dispatched the same way; on a ``ConstDia`` the Jacobi scale ``s`` is one
float. ``spmv_csr`` and ``spmv_dia`` are the reference's public
per-format products: the CSR and the DIA kernel on CUDA tensors, their
plain twins on CPU tensors.
"""

from __future__ import annotations

import torch

from ..amg.structured import GridProlong, GridRestrict
from ..sparse.formats import ConstDia, Csr, Dia, TileCsr
from . import const_stencil, csr_spmv, dia_spmv, grid_transfer, tile_csr


def _kernel_module(a):
    if isinstance(a, ConstDia):
        return const_stencil
    if isinstance(a, Dia):
        return dia_spmv
    if isinstance(a, Csr):
        return csr_spmv
    if isinstance(a, TileCsr):
        return tile_csr
    raise TypeError(f"unsupported operator {type(a).__name__}")


def spmv(a, x: torch.Tensor) -> torch.Tensor:
    """y = A·x."""
    if isinstance(a, GridProlong):
        return grid_transfer.prolong(a, x)
    if isinstance(a, GridRestrict):
        return grid_transfer.restrict(a, x)
    return _kernel_module(a).spmv(a, x)


def residual(a, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """r = b − A·x, fused into the SpMV pass."""
    return _kernel_module(a).residual(a, x, b)


def jacobi(a, x: torch.Tensor, b: torch.Tensor, s) -> torch.Tensor:
    """One weighted-Jacobi sweep x + s ⊙ (b − A·x), fused into the SpMV
    pass (s = ω·D⁻¹: a per-row tensor, or a float on a ``ConstDia``)."""
    return _kernel_module(a).jacobi(a, x, b, s)


def spmv_csr(a: Csr, x: torch.Tensor) -> torch.Tensor:
    """y = A·x for a ``Csr``."""
    return csr_spmv.spmv(a, x)


def spmv_dia(a: Dia, x: torch.Tensor) -> torch.Tensor:
    """y = A·x for a device ``Dia`` (torch planes)."""
    return dia_spmv.spmv(a, x)
