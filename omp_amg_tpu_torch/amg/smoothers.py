"""Smoothers: weighted Jacobi (also l1-Jacobi) and Chebyshev (counterpart
of ``omp_amg_tpu/amg/smoothers.py``).

A weighted-Jacobi sweep x ← x + s ⊙ (b − A·x), s = ω·D⁻¹, is one fused
jacobi-mode kernel launch on CUDA (the stencil kernel on a ``ConstDia``
level with s one number: the reference's ``const_scalar`` path; the DIA
kernel on a banded level; the CSR kernel elsewhere) and its plain twin on
the CPU. l1-Jacobi differs only in the D the setup stored; on a ``ConstDia``
its s varies at the boundary, so the sweep is the stencil kernel's residual
mode and x + s ⊙ r (the reference's ``const_scalar=False``).

Chebyshev applies A through :func:`..ops.spmv.spmv` (its first residual
through the fused residual mode) and keeps the reference's recurrence and
operation order as plain tensor operations, its scalar coefficients
computed in float32 on the host as the reference's traced arithmetic
computes them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.spmv import jacobi as jacobi_kernel
from ..ops.spmv import residual, spmv
from ..sparse.formats import ConstDia, Dia


def jacobi_sweep(a, x: torch.Tensor, b: torch.Tensor, s) -> torch.Tensor:
    """One sweep x + s ⊙ (b − A·x) (s: per-row tensor, or a float on a
    ``ConstDia``)."""
    if isinstance(a, ConstDia) and not isinstance(s, float):
        return x + s * residual(a, x, b)
    return jacobi_kernel(a, x, b, s)


def jacobi(a, s, x: torch.Tensor, b: torch.Tensor,
           sweeps: int) -> torch.Tensor:
    """``sweeps`` weighted-Jacobi sweeps from ``x``."""
    for _ in range(sweeps):
        x = jacobi_sweep(a, x, b, s)
    return x


@functools.lru_cache(maxsize=None)
def chebyshev_coeffs(lmax: float, degree: int, ratio: float):
    """float32 scalars of the Chebyshev smoother on D⁻¹A over
    [1.1·λmax/ratio, 1.1·λmax]: θ, and for each of the ``degree − 1``
    further steps (ρₖ₊₁·ρₖ, 2·ρₖ₊₁/δ), in the reference's operation order
    (its Python constants round to float32 first)."""
    f = np.float32
    upper = f(1.1) * f(lmax)
    lower = upper / f(ratio)
    theta = (upper + lower) / f(2.0)
    delta = (upper - lower) / f(2.0)
    sigma = theta / delta
    rho = f(1.0) / sigma
    steps = []
    for _ in range(degree - 1):
        rho_new = f(1.0) / (f(2.0) * sigma - rho)
        steps.append((float(rho_new * rho), float(f(2.0) * rho_new / delta)))
        rho = rho_new
    return float(theta), tuple(steps)


def chebyshev(a, dinv, x, b: torch.Tensor, lmax: float, degree: int,
              ratio: float, x_is_zero: bool = False) -> torch.Tensor:
    """Chebyshev polynomial smoother on D⁻¹A (``degree`` products with A;
    ``dinv``: per-row tensor or a float). A fixed polynomial in D⁻¹A, so
    symmetric as a preconditioner component.

    ``x_is_zero=True`` skips the first residual product exactly (A·0 ≡ 0):
    the pre-smoother starts from zero (``x`` is then ignored)."""
    theta, steps = chebyshev_coeffs(float(lmax), int(degree), float(ratio))
    r = dinv * b if x_is_zero else dinv * residual(a, x, b)
    d = r / theta
    x = d if x_is_zero else x + d
    for c_d, c_r in steps:
        r = r - dinv * spmv(a, d)
        d = c_d * d + c_r * r
        x = x + d
    return x


def _device(a) -> torch.device:
    if isinstance(a, ConstDia):
        return a.device
    return (a.data if isinstance(a, Dia) else a.vals).device


def estimate_lmax(a, dinv, iters: int = 20) -> float:
    """Largest eigenvalue of D⁻¹A by power iteration in float32 from the
    deterministic hash01 start vector (the reference's device estimator;
    the host setups run :func:`.hierarchy._estimate_lmax_apply`): the
    value of :func:`lmax_tensor`."""
    return float(lmax_tensor(a, dinv, iters))


def lmax_tensor(a, dinv, iters: int = 20) -> torch.Tensor:
    """:func:`estimate_lmax` as a 0-d f32 tensor on ``a``'s device, with no
    host read (so a CUDA graph can hold it). The start vector is hashed
    where ``a`` lives (bit for bit ``hash01_np``'s), not on the host and
    copied: that took 0.4 s of each 256³ structured refresh on the H100's
    host."""
    from .pmis import hash01

    v = hash01(torch.arange(a.n_rows, device=_device(a))) - 0.5
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = dinv * spmv(a, v)
        v = w / torch.linalg.vector_norm(w)
    w = dinv * spmv(a, v)
    return torch.dot(v, w) / torch.dot(v, v)
