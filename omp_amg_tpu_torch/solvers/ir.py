"""Mixed-precision iterative refinement around the f32 device solver
(counterpart of ``omp_amg_tpu/solvers/ir.py``: ``solve_ir`` and
``solve_ir_device``).

The AMG-PCG loop runs in f32 on the device; an outer defect-correction loop
computes true residuals in f64 (one SpMV per restart) and re-solves on the
scaled defect until the f64 target is met. ``solve_ir`` forms the residual
on the host; ``solve_ir_device`` keeps b, x and the fine operator's planes
in float64 on the device (native f64: the reference emulates it with
double-float32 pairs, ``ops/df64.py``, which the port does not carry), so
one scalar norm per outer pass is all that reaches the host. Each outer
pass's inner tolerance τ goes to the captured PCG as an input of its graphs
(``graph=True``, :mod:`.graph`), so every pass replays the graphs captured
in the first: the reference's traced ``tol``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..amg.hierarchy import Hierarchy, fine_operator
from ..ops import ir_f64
from ..sparse.formats import Dia
from ..utils.trace import span
from .cg import amg_pcg


class IRResult(NamedTuple):
    x: object                # f64 solution: a host array, or a float64
                             # device tensor (solve_ir_device to_host=False)
    outer_iters: int
    inner_iters: list        # PCG iterations per restart
    rel_residual: float      # true f64 ‖b−Ax‖/‖b‖
    histories: list          # PCG ‖r_k‖ history per restart


def solve_ir(a_apply, b, a_dev, hier: Hierarchy, tol: float = 1e-8,
             inner_tol: float = 1e-6, maxiter: int = 200,
             max_outer: int = 8, variant: str = "standard",
             graph: bool = True) -> IRResult:
    """Solve to f64 tolerance ``tol`` using the f32 device AMG-PCG.

    ``a_apply``: the true-residual operator in f64, a callable
    ``v -> A v`` (such as ``native.CsrMatvec``);
    ``a_dev``: the device operator matching ``hier``'s fine level;
    ``variant``, ``graph``: the PCG variant and loop (:func:`.cg.amg_pcg`).
    """
    b = np.asarray(b, dtype=np.float64)
    bnorm = np.linalg.norm(b)
    if bnorm == 0:
        return IRResult(np.zeros_like(b), 0, [], 0.0, [])
    x = np.zeros_like(b)
    inner_iters = []
    histories = []
    for outer in range(max_outer + 1):
        with span("ir.residual"):
            r = b - a_apply(x)
            scale = np.linalg.norm(r)
            rel = float(scale / bnorm)
            if rel <= tol or outer == max_outer:
                break
            rhs = torch.from_numpy((r / scale).astype(np.float32)).to(
                hier.device)
        # adaptive inner tolerance: the defect only needs a relative
        # reduction of tol/rel (×0.3 safety)
        tau = max(inner_tol, 0.3 * tol / rel)
        res = amg_pcg(a_dev, rhs, hier, tol=tau, maxiter=maxiter,
                      variant=variant, graph=graph)
        inner_iters.append(res.iters)
        histories.append(res.history)
        with span("ir.update"):
            x = x + scale * res.x.cpu().numpy().astype(np.float64)
    with span("ir.result"):   # x is on the host already
        return IRResult(x, len(inner_iters), inner_iters, rel, histories)


def solve_ir_device(a, b, hier: Hierarchy, tol: float = 1e-8,
                    inner_tol: float = 1e-6, maxiter: int = 200,
                    max_outer: int = 8, variant: str = "standard",
                    a_dev=None, to_host: bool = True,
                    graph: bool = True) -> IRResult:
    """Device-resident iterative refinement: the loop of :func:`solve_ir`
    with the true residual r = b − A·x formed on the hierarchy's device in
    native float64, once per outer pass.

    ``a``: the fine operator as a plain ``Dia`` (numpy or torch planes,
    taken in float64 on the device: pass them there already to skip the
    copy); ``b``: the right-hand side (numpy array or tensor, taken in
    float64); ``a_dev``: the inner PCG's device operator (default: the
    hierarchy's level-0 operator). ``to_host=False`` returns x as a
    float64 tensor on the device (no host copy of x). ``variant``,
    ``graph``: the PCG variant and loop (:func:`.cg.amg_pcg`).
    """
    if not isinstance(a, Dia):
        raise TypeError("solve_ir_device needs a plain Dia fine operator")
    dev = hier.device
    offsets = tuple(int(o) for o in a.offsets)
    data = a.data if isinstance(a.data, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a.data))
    a64 = Dia(data=data.to(dev, torch.float64).contiguous(), offsets=offsets)
    if a_dev is None:
        a_dev = hier.levels[0].a if hier.levels else fine_operator(a, dev)
    b = b if isinstance(b, torch.Tensor) else torch.from_numpy(
        np.asarray(b, np.float64))
    b = b.to(dev, torch.float64).contiguous()
    bnorm = float(torch.linalg.vector_norm(b))
    x = torch.zeros_like(b)
    inner_iters, histories = [], []
    rel = 0.0
    for outer in range(max_outer + 1):
        if bnorm == 0:
            break
        with span("ir.residual"):
            r = ir_f64.residual(a64, x, b)
            rnorm = float(torch.linalg.vector_norm(r))
            rel = rnorm / bnorm
            if rel <= tol or outer == max_outer:
                break
            defect = ir_f64.defect(r, rnorm)
        tau = max(inner_tol, 0.3 * tol / rel)
        res = amg_pcg(a_dev, defect, hier, tol=tau,
                      maxiter=maxiter, variant=variant, graph=graph)
        inner_iters.append(res.iters)
        histories.append(res.history)
        with span("ir.update"):
            ir_f64.update(x, rnorm, res.x)
    with span("ir.result"):
        x = x.cpu().numpy() if to_host else x
    return IRResult(x, len(inner_iters), inner_iters, rel, histories)
