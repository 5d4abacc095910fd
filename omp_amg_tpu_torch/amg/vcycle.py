"""Multigrid cycle preconditioner (counterpart of
``omp_amg_tpu/amg/vcycle.py``).

Per level: pre-smooth from a zero guess, residual (fused kernel mode),
restrict, visit the coarse level, x + P·xc (the correct mode of the CSR
kernel or of the grid-transfer kernel), post-smooth; a dense coarse
solve at the bottom (Cholesky, or one product with the stored inverse).
``params.cycle`` shapes the coarse visits: "v" one, "w" two (the second on
the first's residual), "f" an F-recursion then a V-recursion. Zero initial
guess and symmetric smoothing keep the cycle a fixed SPD operator, as PCG
requires.

A ``ConstDia`` level with Jacobi V(1,1) smoothing and a scalar s runs the
reference's fused pair of stencil launches in every descent: ``zjr``
(r = b − s·A·b: pre-smooth and residual), then ``cja`` (u = s·b + P·xc,
x = u + s·(b − A·u): correction and post-smooth). The reference fuses only
on the TPU; the port fuses on every device, so the CPU runs exercise the
card's algebra. It reassociates the pre-smoothed residual, s·Σc·b against
Σc·(s·b), within an ulp per tap of the unfused sweep.
"""

from __future__ import annotations

import torch

from ..ops import const_stencil, csr_spmv, grid_transfer
from ..ops.spmv import residual, spmv
from ..sparse.formats import ConstDia, Csr
from .hierarchy import Hierarchy, Level
from .params import AMGParams
from .smoothers import chebyshev, jacobi


def _smooth(level: Level, params: AMGParams, x: torch.Tensor,
            b: torch.Tensor, sweeps: int) -> torch.Tensor:
    if params.smoother == "chebyshev":
        for _ in range(sweeps):
            x = chebyshev(level.a, level.dinv_dev, x, b, level.lmax,
                          params.cheby_degree, params.cheby_ratio)
        return x
    return jacobi(level.a, level.s, x, b, sweeps)


def _smooth_zero(level: Level, params: AMGParams, b: torch.Tensor,
                 sweeps: int) -> torch.Tensor:
    """Smooth from a known-zero guess, skipping the first SpMV: A·0 is
    exactly zero, so the first Jacobi sweep is s ⊙ b and the first
    Chebyshev residual D⁻¹·b (bitwise the full sweep)."""
    if sweeps == 0:
        return torch.zeros_like(b)
    if params.smoother == "chebyshev":
        x = chebyshev(level.a, level.dinv_dev, None, b, level.lmax,
                      params.cheby_degree, params.cheby_ratio, x_is_zero=True)
        return _smooth(level, params, x, b, sweeps - 1)
    return jacobi(level.a, level.s, level.s * b, b, sweeps - 1)


def _fused_v11_level(lv: Level, params: AMGParams) -> bool:
    """True when the level runs the fused ConstDia V(1,1) pair."""
    return (isinstance(lv.a, ConstDia) and isinstance(lv.s, float)
            and params.smoother == "jacobi"
            and params.nu_pre == 1 and params.nu_post == 1)


def coarse_solve(hier, b: torch.Tensor) -> torch.Tensor:
    """Dense direct solve at the coarsest level: two triangular solves with
    the Cholesky factor from the setup, or one product with the stored
    inverse (``coarse_solver="inv"``). ``hier``: any hierarchy with
    ``coarse_chol`` and ``params``."""
    if hier.params.coarse_solver == "inv":
        return torch.mv(hier.coarse_chol, b)
    chol = hier.coarse_chol
    y = torch.linalg.solve_triangular(chol, b[:, None], upper=False)
    return torch.linalg.solve_triangular(chol.T, y, upper=True)[:, 0]


def _coarse_visit(hier, l: int, bc: torch.Tensor, cyc: str) -> torch.Tensor:
    """Solve the level-l problem per the cycle type (l ≥ 1)."""
    if l == len(hier.levels):
        return coarse_solve(hier, bc)
    # the reference caps the W-branching depth (its cycle unrolls in one
    # trace); kept for parity
    if cyc == "v" or l > 8:
        return _descend(hier, l, bc, "v")
    x1 = _descend(hier, l, bc, cyc)
    # the second visit refines x1 on its residual (W: the same cycle type;
    # F: a V-recursion)
    r2 = residual(hier.levels[l].a, x1, bc)
    return x1 + _descend(hier, l, r2, "v" if cyc == "f" else cyc)


def _descend(hier, l: int, bl: torch.Tensor, cyc: str) -> torch.Tensor:
    if l == len(hier.levels):
        return coarse_solve(hier, bl)
    params = hier.params
    lv = hier.levels[l]
    if _fused_v11_level(lv, params):
        r = const_stencil.presmooth_residual(lv.a, bl, lv.s)
        xc = _coarse_visit(hier, l + 1, spmv(lv.r, r), cyc)
        return const_stencil.correct_jacobi(lv.a, bl, spmv(lv.p, xc), lv.s)
    x = _smooth_zero(lv, params, bl, params.nu_pre)
    xc = _coarse_visit(hier, l + 1, spmv(lv.r, residual(lv.a, x, bl)), cyc)
    if isinstance(lv.p, Csr):
        x = csr_spmv.correct(lv.p, xc, x)
    else:
        x = grid_transfer.correct(lv.p, xc, x)
    return _smooth(lv, params, x, bl, params.nu_post)


def vcycle(hier: Hierarchy, b: torch.Tensor) -> torch.Tensor:
    """One cycle of type ``params.cycle`` applied to b with zero initial
    guess → M⁻¹ b. (The recursion is two module functions, not nested
    closures: closures that call each other form a reference cycle, which
    would keep the hierarchy, and the CUDA graphs cached on it, alive until
    a garbage collection.)"""
    return _descend(hier, 0, b, hier.params.cycle)


def vcycle_apply(hier: Hierarchy, x: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """x + M⁻¹(b − A·x): the cycle as one stationary iteration (a
    standalone AMG solve step)."""
    r = residual(hier.levels[0].a, x, b) if hier.levels else b
    return x + vcycle(hier, r)
