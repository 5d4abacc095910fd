"""AMG-preconditioned conjugate gradient (counterpart of
``omp_amg_tpu/solvers/cg.py``: ``pcg`` and ``amg_pcg``).

A Python loop over device tensors. The scalars α, β and (r, z) stay on the
device; the one host synchronisation per iteration is the residual norm of
the convergence check.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..amg.hierarchy import Hierarchy
from ..amg.vcycle import vcycle
from ..ops.spmv import spmv


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    rel_residual: float      # ‖r_k‖/‖b‖ (recursive residual)
    history: list            # ‖r_k‖ per iteration, k = 0..iters


def pcg(a, b: torch.Tensor, precond: Callable, tol: float = 1e-8,
        maxiter: int = 500, x0=None) -> CGResult:
    """Solve A x = b with preconditioner ``precond`` (M⁻¹ apply, a fixed
    SPD linear operator)."""
    if x0 is None:
        x = torch.zeros_like(b)
        r = b.clone()            # b − A·0, bitwise
    else:
        x = x0
        r = b - spmv(a, x)
    bnorm = np.float32(torch.linalg.vector_norm(b).item())
    if bnorm == 0:
        bnorm = np.float32(1.0)
    # the reference compares ‖r‖ > tol·‖b‖ in float32
    threshold = float(np.float32(tol) * bnorm)
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    rnorm = torch.linalg.vector_norm(r).item()
    history = [rnorm]
    k = 0
    while rnorm > threshold and k < maxiter:
        q = spmv(a, p)
        alpha = rz / torch.dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        z = precond(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
        rnorm = torch.linalg.vector_norm(r).item()
        history.append(rnorm)
    return CGResult(x=x, iters=k, rel_residual=float(rnorm / bnorm),
                    history=history)


def amg_pcg(a, b: torch.Tensor, hier: Hierarchy, tol: float = 1e-8,
            maxiter: int = 500, x0=None) -> CGResult:
    """PCG with M⁻¹ = one V-cycle of ``hier``."""
    return pcg(a, b, precond=lambda r: vcycle(hier, r), tol=tol,
               maxiter=maxiter, x0=x0)
