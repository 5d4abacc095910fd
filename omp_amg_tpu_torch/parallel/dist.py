"""Distributed hierarchy and sharded AMG-PCG, the structured subset
(counterpart of ``omp_amg_tpu/parallel/dist.py``).

Levels whose vectors are sharded hold z-slab operators (:mod:`.slab`);
levels below the agglomeration threshold are replicated: one full vector,
the port's own single-device operators (``Dia``, ``ConstDia``, the grid
transfers) and kernels. The shard→replicated transition restricts with
``gather_out`` and prolongs with ``slice_in``. Global dots and norms are
sums over the shards in shard order (:func:`.mesh.psum`), the only global
sync points of PCG; the convergence check syncs once per iteration, as the
single-device PCG does.

The PMIS distribution (``DistOp``, halo/gather modes, the routed ELL
branch) and the pipelined PCG variant are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..amg.params import AMGParams
from ..amg.vcycle import coarse_solve
from ..ops import spmv as ops
from ..solvers.cg import CGResult
from .mesh import psum
from .slab import (
    SlabDia, SlabProlong, SlabRestrict, slab_apply, slab_prolong,
    slab_restrict,
)


@dataclass(frozen=True)
class DistLevel:
    a: object                  # SlabDia (sharded) or a replicated operator
    dinv: object               # per-shard list or one tensor, f32
    p: object                  # SlabProlong | GridProlong
    r: object                  # SlabRestrict | GridRestrict
    lmax: float                # f32 value
    s: object                  # Jacobi scale ω·dinv: per-shard list, one
                               # tensor, or a float on a ConstDia level
    sharded: bool              # this level's vectors are sharded


@dataclass(frozen=True)
class DistHierarchy:
    levels: Tuple[DistLevel, ...]
    coarse_chol: torch.Tensor  # replicated lower Cholesky factor
    params: AMGParams

    @property
    def nshards(self) -> int:
        for lv in self.levels:
            if isinstance(lv.a, SlabDia):
                return len(lv.a.blocks)
        return 1


def _map(fn, *vs):
    """``fn`` per shard of sharded (list) arguments, or once on tensors."""
    if isinstance(vs[0], list):
        return [fn(*t) for t in zip(*vs)]
    return fn(*vs)


def dist_spmv(op, x, d: int):
    """y = A·x for every operator family of the structured distribution:
    z-slab operators on shard lists, replicated ones on full vectors
    (``d``: the shard count, for a ``slice_in`` prolongation)."""
    if isinstance(op, SlabDia):
        return slab_apply(op, x)
    if isinstance(op, SlabProlong):
        return slab_prolong(op, x, d)
    if isinstance(op, SlabRestrict):
        return slab_restrict(op, x)
    return ops.spmv(op, x)


def pdot(a, b) -> torch.Tensor:
    """Global dot (0-dim tensor on the device): per-shard dots summed in
    shard order."""
    if isinstance(a, list):
        return psum([torch.dot(x, y) for x, y in zip(a, b)])
    return torch.dot(a, b)


def pnorm(a) -> torch.Tensor:
    return torch.sqrt(pdot(a, a))


def _residual(lv: DistLevel, x, b):
    if lv.sharded:
        return slab_apply(lv.a, x, "residual", bs=b)
    return ops.residual(lv.a, x, b)


def _smooth(lv: DistLevel, params: AMGParams, x, b, sweeps: int,
            x_is_zero: bool = False):
    """Weighted-Jacobi sweeps x ← x + s ⊙ (b − A·x), one fused jacobi-mode
    launch per shard each; ``x_is_zero=True`` makes the first sweep s ⊙ b
    (A·0 ≡ 0, bitwise the full sweep)."""
    for k in range(sweeps):
        if k == 0 and x_is_zero:
            x = _map(lambda s, bb: s * bb, lv.s, b)
        elif lv.sharded:
            x = slab_apply(lv.a, x, "jacobi", bs=b, ss=lv.s)
        else:
            x = ops.jacobi(lv.a, x, b, lv.s)
    if x_is_zero and sweeps == 0:
        x = _map(torch.zeros_like, b)
    return x


def dist_vcycle(dh: DistHierarchy, b):
    """One V-cycle with zero initial guess: b and the result are shard lists
    (or full vectors when level 0 is replicated)."""
    params = dh.params
    levels = dh.levels
    d = dh.nshards

    def descend(l, bl):
        if l == len(levels):
            return coarse_solve(dh, bl)
        lv = levels[l]
        x = _smooth(lv, params, None, bl, params.nu_pre, x_is_zero=True)
        bc = dist_spmv(lv.r, _residual(lv, x, bl), d)
        xc = descend(l + 1, bc)
        x = _map(torch.add, x, dist_spmv(lv.p, xc, d))
        return _smooth(lv, params, x, bl, params.nu_post)

    return descend(0, b)


def _dist_pcg_local(dh: DistHierarchy, b, tol: float,
                    maxiter: int) -> CGResult:
    """Sharded AMG-PCG from x = 0 (``b``: shard list). The scalars stay on
    the device; the one host sync per iteration is the residual norm."""
    a = dh.levels[0].a
    d = dh.nshards
    x = _map(torch.zeros_like, b)
    r = _map(torch.clone, b)
    bnorm = np.float32(pnorm(b).item())
    if bnorm == 0:
        bnorm = np.float32(1.0)
    # the reference compares ‖r‖ > tol·‖b‖ in float32
    threshold = float(np.float32(tol) * bnorm)
    z = dist_vcycle(dh, r)
    p = z
    rz = pdot(r, z)
    rnorm = pnorm(r).item()
    history = [rnorm]
    k = 0
    while rnorm > threshold and k < maxiter:
        q = dist_spmv(a, p, d)
        alpha = rz / pdot(p, q)
        x = _map(lambda xi, pi: xi + alpha * pi, x, p)
        r = _map(lambda ri, qi: ri - alpha * qi, r, q)
        z = dist_vcycle(dh, r)
        rz_new = pdot(r, z)
        beta = rz_new / rz
        p = _map(lambda zi, pi: zi + beta * pi, z, p)
        rz = rz_new
        k += 1
        rnorm = pnorm(r).item()
        history.append(rnorm)
    return CGResult(x=x, iters=k, rel_residual=float(rnorm / bnorm),
                    history=history)


def _as_shards(mesh, dh: DistHierarchy, v):
    if isinstance(v, list) or not dh.levels[0].sharded:
        return v, False
    return mesh.shard(v), True


def make_dist_solver(mesh, dh: DistHierarchy, tol: float = 1e-6,
                     maxiter: int = 200, variant: str = "standard"):
    """The sharded AMG-PCG: ``solve(dh, b[, tol]) → CGResult``. ``b`` is a
    shard list or a full vector (then x comes back full); ``tol`` is the
    default tolerance, overridable per call (the IR outer loop)."""
    if variant == "pipelined":
        raise NotImplementedError("the pipelined (single-reduction) PCG "
                                  "variant is not ported yet")
    if variant != "standard":
        raise ValueError(f"variant={variant!r}")

    def solve(dh, b, tol_s=None):
        bs, full = _as_shards(mesh, dh, b)
        res = _dist_pcg_local(dh, bs, tol if tol_s is None else tol_s,
                              maxiter)
        return res._replace(x=mesh.gather(res.x)) if full else res

    return solve


def make_dist_vcycle(mesh, dh: DistHierarchy):
    """One sharded V-cycle: ``apply(dh, b) → z`` (full vectors or shard
    lists, as given)."""

    def apply(dh, b):
        bs, full = _as_shards(mesh, dh, b)
        z = dist_vcycle(dh, bs)
        return mesh.gather(z) if full else z

    return apply
