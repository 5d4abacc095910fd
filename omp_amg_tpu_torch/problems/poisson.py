"""Test-problem generators (counterpart of
``omp_amg_tpu/problems/poisson.py``).

Dirichlet boundary conditions with eliminated boundary rows (pure interior
unknowns). Operators are built on the host as numpy-backed ``Dia`` (f64);
``AMGSolver`` / ``amg_setup`` move them to the device.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..sparse.formats import Dia


def stencil_to_dia(dims: Sequence[int],
                   taps: Dict[Tuple[int, ...], float]) -> Dia:
    """Build a Dirichlet-masked constant-stencil operator as numpy DIA.

    ``dims`` are grid extents in C order (slowest axis first); unknown
    ``i = sum_k idx[k] * stride[k]``. ``taps`` maps index-offset tuples to
    stencil values; taps reaching outside the grid are masked to zero.
    """
    dims = tuple(int(d) for d in dims)
    ndim = len(dims)
    strides = [1] * ndim
    for k in range(ndim - 2, -1, -1):
        strides[k] = strides[k + 1] * dims[k + 1]
    n = int(np.prod(dims))

    items = sorted(taps.items(),
                   key=lambda kv: sum(d * s for d, s in zip(kv[0], strides)))
    offsets = [sum(d * s for d, s in zip(tap, strides)) for tap, _ in items]
    data = np.zeros((len(items), n), dtype=np.float64)
    idx_grids = np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")
    for k, (tap, value) in enumerate(items):
        mask = np.ones(dims, dtype=bool)
        for ax in range(ndim):
            shifted = idx_grids[ax] + tap[ax]
            mask &= (shifted >= 0) & (shifted < dims[ax])
        data[k] = value * mask.ravel()
    return Dia(data=data, offsets=tuple(offsets), dims=dims)


def poisson2d_5pt(nx: int, ny: int | None = None) -> Dia:
    ny = nx if ny is None else ny
    taps = {(0, 0): 4.0, (0, 1): -1.0, (0, -1): -1.0, (1, 0): -1.0,
            (-1, 0): -1.0}
    return stencil_to_dia((ny, nx), taps)


def poisson3d_7pt(nx: int, ny: int | None = None,
                  nz: int | None = None) -> Dia:
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    taps = {(0, 0, 0): 6.0}
    for ax in range(3):
        for s in (-1, 1):
            tap = [0, 0, 0]
            tap[ax] = s
            taps[tuple(tap)] = -1.0
    return stencil_to_dia((nz, ny, nx), taps)


def poisson3d_27pt(nx: int, ny: int | None = None,
                   nz: int | None = None) -> Dia:
    """27-point 3D Laplacian (all 26 neighbours −1, centre 26)."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    taps = {}
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                taps[(dz, dy, dx)] = 26.0 if dz == dy == dx == 0 else -1.0
    return stencil_to_dia((nz, ny, nx), taps)


def aniso2d_9pt(nx: int, ny: int | None = None, eps: float = 1e-3) -> Dia:
    """−ε·u_xx − u_yy with bilinear quad FEM → 9-point stencil:
    A = ε·(M_y ⊗ K_x) + (K_y ⊗ M_x) with 1D stiffness K = tridiag(−1, 2,
    −1)/h and mass M = tridiag(1, 4, 1)·h/6."""
    ny = nx if ny is None else ny
    h = 1.0 / (nx + 1)
    k1 = {0: 2.0 / h, 1: -1.0 / h, -1: -1.0 / h}
    m1 = {0: 4.0 * h / 6.0, 1: h / 6.0, -1: h / 6.0}
    taps = {}
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            taps[(dy, dx)] = eps * m1[dy] * k1[dx] + k1[dy] * m1[dx]
    return stencil_to_dia((ny, nx), taps)


def default_rhs(a: Dia, kind: str = "random", seed: int = 0) -> torch.Tensor:
    """Benchmark right-hand sides, float32 on the CPU: reproducible random
    (the same values as the reference's ``default_rhs``) or all-ones."""
    n = a.n_rows
    if kind == "ones":
        return torch.ones(n, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(n).astype(np.float32))
