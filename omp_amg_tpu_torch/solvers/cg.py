"""Conjugate gradient solvers (counterpart of ``omp_amg_tpu/solvers/cg.py``:
``pcg``, ``pcg_pipelined``, ``amg_pcg`` and ``cg``).

Python loops over device tensors. Standard PCG keeps α, β and (r, z) on the
device; its one host synchronisation per iteration is the residual norm of
the convergence check. The pipelined (single-reduction) PCG forms γ, δ and
‖r‖² at one point per iteration and reads them with one host copy, then
computes α and β on the host in float32, as the reference's f32 scalars.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..amg.hierarchy import Hierarchy
from ..amg.vcycle import vcycle
from ..ops.spmv import spmv
from ..ops.vecops import axpy, dot

VARIANTS = ("standard", "pipelined")


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    rel_residual: float      # ‖r_k‖/‖b‖ (recursive residual)
    history: list            # ‖r_k‖ per iteration, k = 0..iters


def _start(a, b, x0):
    if x0 is None:
        return torch.zeros_like(b), b.clone()    # r = b − A·0, bitwise
    return x0, b - spmv(a, x0)


def _bnorm(b: torch.Tensor) -> np.float32:
    bnorm = np.float32(torch.linalg.vector_norm(b).item())
    return np.float32(1.0) if bnorm == 0 else bnorm


def pcg(a, b: torch.Tensor, precond: Callable, tol: float = 1e-8,
        maxiter: int = 500, x0=None) -> CGResult:
    """Solve A x = b with preconditioner ``precond`` (M⁻¹ apply, a fixed
    SPD linear operator)."""
    x, r = _start(a, b, x0)
    bnorm = _bnorm(b)
    # the reference compares ‖r‖ > tol·‖b‖ in float32
    threshold = float(np.float32(tol) * bnorm)
    z = precond(r)
    p = z
    rz = dot(r, z)
    rnorm = torch.linalg.vector_norm(r).item()
    history = [rnorm]
    k = 0
    while rnorm > threshold and k < maxiter:
        q = spmv(a, p)
        alpha = rz / dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        z = precond(r)
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
        rnorm = torch.linalg.vector_norm(r).item()
        history.append(rnorm)
    return CGResult(x=x, iters=k, rel_residual=float(rnorm / bnorm),
                    history=history)


def _reduce(r, u, w):
    """γ = (r, u), δ = (w, u) and ‖r‖², formed together and read with one
    host copy: float32 numpy scalars."""
    g, d, rn2 = torch.stack([dot(r, u), dot(w, u), dot(r, r)]).cpu().numpy()
    return g, d, rn2


def pcg_pipelined(a, b: torch.Tensor, precond: Callable, tol: float = 1e-8,
                  maxiter: int = 500, x0=None) -> CGResult:
    """Single-reduction PCG (Chronopoulos–Gear): γ = (r, u), δ = (w, u) and
    ‖r‖² at one reduction point per iteration, α from the recurrence
    α_k = γ_k / (δ_k − β_k·γ_k/α_{k−1}). The same iterates as standard PCG
    in exact arithmetic; the exit test is the reference's f32
    √‖r‖² > tol·‖b‖ on the updated residual."""
    f = np.float32
    x, r = _start(a, b, x0)
    bnorm = _bnorm(b)
    threshold = f(tol) * bnorm
    u = precond(r)
    w = spmv(a, u)
    p = torch.zeros_like(b)
    s = torch.zeros_like(b)
    gamma, delta, rn2 = _reduce(r, u, w)
    history = [float(np.sqrt(rn2))]
    g_prev = a_prev = f(1.0)
    k = 0
    while np.sqrt(rn2) > threshold and k < maxiter:
        beta = f(0.0) if k == 0 else gamma / g_prev
        alpha = gamma / (delta - beta * gamma / a_prev)
        p = axpy(float(beta), p, u)
        s = axpy(float(beta), s, w)
        x = axpy(float(alpha), p, x)
        r = axpy(float(-alpha), s, r)
        u = precond(r)
        w = spmv(a, u)
        g_prev, a_prev = gamma, alpha
        gamma, delta, rn2 = _reduce(r, u, w)
        k += 1
        history.append(float(np.sqrt(rn2)))
    return CGResult(x=x, iters=k, rel_residual=float(np.sqrt(rn2) / bnorm),
                    history=history)


def amg_pcg(a, b: torch.Tensor, hier: Hierarchy, tol: float = 1e-8,
            maxiter: int = 500, x0=None,
            variant: str = "standard") -> CGResult:
    """PCG with M⁻¹ = one cycle of ``hier``; ``variant="pipelined"`` is the
    single-reduction PCG (:func:`pcg_pipelined`)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant={variant!r} (supported: "
                         f"{', '.join(VARIANTS)})")
    fn = pcg_pipelined if variant == "pipelined" else pcg
    return fn(a, b, precond=lambda r: vcycle(hier, r), tol=tol,
              maxiter=maxiter, x0=x0)


def cg(a, b: torch.Tensor, tol: float = 1e-8, maxiter: int = 500,
       x0=None) -> CGResult:
    """Unpreconditioned CG (the baseline)."""
    return pcg(a, b, precond=lambda r: r, tol=tol, maxiter=maxiter, x0=x0)
