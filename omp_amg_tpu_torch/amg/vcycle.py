"""V-cycle multigrid preconditioner (counterpart of the V branch of
``omp_amg_tpu/amg/vcycle.py``).

Per level: pre-smooth from a zero guess, residual (fused kernel mode),
restrict, recurse, x + P·xc (the CSR kernel's correct mode, or a plain add
after the grid prolongation), post-smooth; a dense Cholesky solve at the
bottom. Zero initial guess and symmetric smoothing keep the cycle a fixed
SPD operator, as PCG requires.

A ``ConstDia`` level with Jacobi V(1,1) runs the reference's fused pair of
stencil launches: ``zjr`` (r = b − s·A·b: pre-smooth and residual), then
``cja`` (u = s·b + P·xc, x = u + s·(b − A·u): correction and post-smooth).
The reference fuses only on the TPU; the port fuses on every device, so the
CPU runs exercise the card's algebra. It reassociates the pre-smoothed
residual, s·Σc·b against Σc·(s·b), within an ulp per tap of the unfused
sweep.
"""

from __future__ import annotations

import torch

from ..ops import const_stencil, csr_spmv
from ..ops.spmv import residual, spmv
from ..sparse.formats import ConstDia, Csr
from .hierarchy import Hierarchy, Level
from .params import AMGParams
from .smoothers import jacobi


def _smooth_zero(level: Level, b: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Smooth from a known-zero guess, skipping the first SpMV: A·0 is
    exactly zero, so the first sweep is s ⊙ b (bitwise the full sweep)."""
    if sweeps == 0:
        return torch.zeros_like(b)
    return jacobi(level.a, level.s, level.s * b, b, sweeps - 1)


def _fused_v11_level(lv: Level, params: AMGParams) -> bool:
    """True when the level runs the fused ConstDia V(1,1) pair."""
    return (isinstance(lv.a, ConstDia) and params.smoother == "jacobi"
            and params.nu_pre == 1 and params.nu_post == 1)


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
        if _fused_v11_level(lv, params):
            r = const_stencil.presmooth_residual(lv.a, bl, lv.s)
            xc = descend(l + 1, spmv(lv.r, r))
            return const_stencil.correct_jacobi(lv.a, bl, spmv(lv.p, xc),
                                                lv.s)
        x = _smooth_zero(lv, bl, params.nu_pre)
        xc = descend(l + 1, spmv(lv.r, residual(lv.a, x, bl)))
        if isinstance(lv.p, Csr):
            x = csr_spmv.correct(lv.p, xc, x)
        else:
            x = x + spmv(lv.p, xc)
        return jacobi(lv.a, lv.s, x, bl, params.nu_post)

    return descend(0, b)
