"""Certified distributed solve: f64 iterative refinement over the mesh
(counterpart of ``omp_amg_tpu/parallel/dist_ir.py``).

The defect-correction outer loop keeps x and b in float64 on the shards and
computes the true residual r = b − A·x there, in native float64 (the
reference emulates it with double-float32 pairs, ``ops/df64.py``; the card
has f64 arithmetic, so the port does not carry that module). The product is
a plain f64 slab product with the plain exchange: it runs once per outer
pass (2–3 per solve), not per V-cycle. The norm is one shard-order sum; the
unit residual goes to the f32 sharded AMG-PCG (:mod:`.dist`) at an adaptive
tolerance.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solvers.ir import IRResult, dia_apply_f64
from .dist import DistHierarchy, make_dist_solver, pdot
from .slab import SlabDia, slab_windows


def _f64_slab_spmv(op: SlabDia, xs):
    """y = A·x in float64 per shard over its exchanged window
    (:func:`..solvers.ir.dia_apply_f64`)."""
    n_loc = xs[0].numel()
    return [dia_apply_f64(op.offsets, blk.data, w, x_base=base, n_rows=n_loc)
            for blk, (w, base) in zip(op.blocks,
                                      slab_windows(op, xs, "ppermute"))]


def _residual_local(a_op: SlabDia, bs, xs):
    """One IR refresh: r = b − A·x (f64), its norm (a python float) and the
    unit residual r/‖r‖ as f32 shards."""
    rs = [b - y for b, y in zip(bs, _f64_slab_spmv(a_op, xs))]
    rnorm = float(torch.sqrt(pdot(rs, rs)).item())
    safe = rnorm if rnorm != 0 else 1.0
    return [(r / safe).float() for r in rs], rnorm


def supports_df64(dh: DistHierarchy) -> bool:
    """True when the fine level has a distributed f64 residual: a z-slab
    fine operator (the name is the reference's; the port's residual is
    native f64)."""
    return isinstance(dh.levels[0].a, SlabDia)


def make_dist_ir_solver(mesh, dh: DistHierarchy, tol: float = 1e-8,
                        inner_tol: float = 1e-6, maxiter: int = 200,
                        max_outer: int = 8, variant: str = "standard"):
    """The certified distributed solver: ``solve(dh, b) → IRResult`` for a
    host f64 right-hand side ``b`` (level 0's global rows); x comes back as
    a host f64 array."""
    if not supports_df64(dh):
        raise NotImplementedError("the certified distributed solve needs a "
                                  "z-slab fine level")
    inner = make_dist_solver(mesh, dh, tol=inner_tol, maxiter=maxiter,
                             variant=variant)

    def solve(dh_in, b) -> IRResult:
        b = np.asarray(b, np.float64)
        bnorm = float(np.linalg.norm(b))
        if bnorm == 0:
            return IRResult(np.zeros_like(b), 0, [], 0.0, [])
        bs = mesh.shard(torch.from_numpy(b))
        xs = [torch.zeros_like(t) for t in bs]
        a0 = dh_in.levels[0].a
        inner_iters, histories = [], []
        rel = 1.0
        for outer in range(max_outer + 1):
            r_unit, rnorm = _residual_local(a0, bs, xs)
            rel = rnorm / bnorm
            if rel <= tol or outer == max_outer:
                break
            tau = max(inner_tol, 0.3 * tol / rel)
            res = inner(dh_in, r_unit, tau)
            inner_iters.append(res.iters)
            histories.append(res.history)
            xs = [x + rnorm * e.double() for x, e in zip(xs, res.x)]
        x = mesh.gather(xs).cpu().numpy()
        return IRResult(x, len(inner_iters), inner_iters, rel, histories)

    return solve
