"""Weighted-Jacobi smoothing (counterpart of
``omp_amg_tpu/amg/smoothers.py::jacobi``).

Each sweep x ← x + s ⊙ (b − A·x), s = ω·D⁻¹, is one fused jacobi-mode
kernel launch on CUDA (the stencil kernel on a ``ConstDia`` level, with s
one number: the reference's ``const_scalar`` path; the DIA kernel on a
banded level; the CSR kernel elsewhere) and its plain twin on the CPU.
"""

from __future__ import annotations

import torch

from ..ops.spmv import jacobi as jacobi_sweep


def jacobi(a, s, x: torch.Tensor, b: torch.Tensor,
           sweeps: int) -> torch.Tensor:
    """``sweeps`` weighted-Jacobi sweeps from ``x`` (s = ω·dinv per row, or
    one float on a ``ConstDia``)."""
    for _ in range(sweeps):
        x = jacobi_sweep(a, x, b, s)
    return x
