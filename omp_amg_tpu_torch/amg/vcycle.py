"""V-cycle multigrid preconditioner (counterpart of the V branch of
``omp_amg_tpu/amg/vcycle.py``).

Per level: pre-smooth from a zero guess, residual (fused kernel mode),
restrict, recurse, x + P·xc (the CSR kernel's correct mode), post-smooth;
a dense Cholesky solve at the bottom. Zero initial guess and symmetric
smoothing keep the cycle a fixed SPD operator, as PCG requires.
"""

from __future__ import annotations

import torch

from ..ops import csr_spmv
from ..ops.spmv import residual, spmv
from .hierarchy import Hierarchy, Level
from .smoothers import jacobi


def _smooth_zero(level: Level, b: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Smooth from a known-zero guess, skipping the first SpMV: A·0 is
    exactly zero, so the first sweep is s ⊙ b (bitwise the full sweep)."""
    if sweeps == 0:
        return torch.zeros_like(b)
    return jacobi(level.a, level.s, level.s * b, b, sweeps - 1)


def coarse_solve(hier: Hierarchy, b: torch.Tensor) -> torch.Tensor:
    """Dense direct solve at the coarsest level: two triangular solves with
    the Cholesky factor from the setup."""
    chol = hier.coarse_chol
    y = torch.linalg.solve_triangular(chol, b[:, None], upper=False)
    return torch.linalg.solve_triangular(chol.T, y, upper=True)[:, 0]


def vcycle(hier: Hierarchy, b: torch.Tensor) -> torch.Tensor:
    """One V-cycle applied to b with zero initial guess → M⁻¹ b."""
    params = hier.params
    levels = hier.levels

    def descend(l, bl):
        if l == len(levels):
            return coarse_solve(hier, bl)
        lv = levels[l]
        x = _smooth_zero(lv, bl, params.nu_pre)
        xc = descend(l + 1, spmv(lv.r, residual(lv.a, x, bl)))
        x = csr_spmv.correct(lv.p, xc, x)
        return jacobi(lv.a, lv.s, x, bl, params.nu_post)

    return descend(0, b)
