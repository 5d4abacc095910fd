"""Mixed-precision iterative refinement around the f32 device solver
(counterpart of ``omp_amg_tpu/solvers/ir.py::solve_ir``).

The AMG-PCG loop runs in f32 on the device; an outer defect-correction loop
computes true residuals in f64 on the host (one SpMV per restart) and
re-solves on the scaled defect until the f64 target is met.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..amg.hierarchy import Hierarchy
from .cg import amg_pcg


class IRResult(NamedTuple):
    x: np.ndarray            # f64 host solution
    outer_iters: int
    inner_iters: list        # PCG iterations per restart
    rel_residual: float      # true f64 ‖b−Ax‖/‖b‖
    histories: list          # PCG ‖r_k‖ history per restart


def solve_ir(a_apply, b, a_dev, hier: Hierarchy, tol: float = 1e-8,
             inner_tol: float = 1e-6, maxiter: int = 200,
             max_outer: int = 8) -> IRResult:
    """Solve to f64 tolerance ``tol`` using the f32 device AMG-PCG.

    ``a_apply``: the true-residual operator in f64, a callable
    ``v -> A v`` (such as ``native.CsrMatvec``);
    ``a_dev``: the device operator matching ``hier``'s fine level.
    """
    b = np.asarray(b, dtype=np.float64)
    bnorm = np.linalg.norm(b)
    if bnorm == 0:
        return IRResult(np.zeros_like(b), 0, [], 0.0, [])
    x = np.zeros_like(b)
    inner_iters = []
    histories = []
    for outer in range(max_outer):
        r = b - a_apply(x)
        rel = float(np.linalg.norm(r) / bnorm)
        if rel <= tol:
            return IRResult(x, outer, inner_iters, rel, histories)
        scale = np.linalg.norm(r)
        # adaptive inner tolerance: the defect only needs a relative
        # reduction of tol/rel (×0.3 safety)
        tau = max(inner_tol, 0.3 * tol / rel)
        rhs = torch.from_numpy((r / scale).astype(np.float32)).to(hier.device)
        res = amg_pcg(a_dev, rhs, hier, tol=tau, maxiter=maxiter)
        inner_iters.append(res.iters)
        histories.append(res.history)
        x = x + scale * res.x.cpu().numpy().astype(np.float64)
    r = b - a_apply(x)
    rel = float(np.linalg.norm(r) / bnorm)
    return IRResult(x, max_outer, inner_iters, rel, histories)
