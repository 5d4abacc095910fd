"""Distributed hierarchy and sharded AMG-PCG (counterpart of
``omp_amg_tpu/parallel/dist.py``).

Two operator families shard a level's rows over the mesh:

- z-slab operators (:mod:`.slab`) for the structured path: per-shard DIA
  blocks, plane exchanges, slab-local grid transfers;
- the general-sparsity family of the classical (PMIS) path: a
  :class:`DistOp` holds one ``Csr`` block per shard, its rows of the
  (padded) operator, in one of three modes decided at partition time
  (:mod:`.partition`):

  - ``halo``: the columns are local to the shard's window ``[h left | m_in
    own | h right]`` (the reference localises them the same way), so the
    product is the window exchange (``transport``: plain strip copies,
    ``"ppermute"``, or one ``remote_halo`` launch for every shard,
    ``"remote"``) and one ``csr_spmv`` launch per shard. The reference's
    exchange is circular and the port's zero-fills the global ends; no
    valid column of shard 0 lies left of its block, nor one of the last
    shard right of it, so the two agree;
  - ``gather``: a halo wider than a block; the columns are global and the
    window is every shard's block, concatenated;
  - ``replicated``: the prolongation at the shard → replicated transition:
    rows sharded, the input the full coarse vector, global columns; its
    ``tblocks`` hold per shard the block of Pᵀ whose columns are that
    shard's fine rows, so that the restriction is one ``csr_spmv`` launch
    per shard and a shard-order sum (no scatter, no atomics).

Levels below the agglomeration threshold are replicated: one full vector,
the port's own single-device operators (``Csr`` or ``Dia``, ``ConstDia``,
the grid transfers) and kernels. Global dots and norms are sums over the
shards in shard order (:func:`.mesh.psum`), the only global sync points of
PCG; the convergence check syncs once per iteration, as the single-device
PCG does. The pipelined (single-reduction) PCG sums its three scalars over
the shards at one point per iteration. The smoothers (Jacobi, l1-Jacobi,
Chebyshev), the V, W and F cycles and both coarse solves are the
single-device ones, applied per shard, on either family.

The reference's routed-ELL plans and its interior/boundary row split are
left out: every shard's rows run from its window in one ``csr_spmv`` pass.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..amg.params import AMGParams
from ..amg.smoothers import chebyshev_coeffs, jacobi_sweep
from ..amg.vcycle import coarse_solve
from ..ops import csr_spmv
from ..ops import spmv as ops
from ..solvers.cg import VARIANTS, CGResult
from ..sparse.formats import Csr
from .mesh import psum
from .slab import (
    SlabDia, SlabProlong, SlabRestrict, _exchange_planes,
    _exchange_planes_remote, check_transport, slab_apply, slab_prolong,
    slab_restrict,
)

MODES = ("halo", "gather", "replicated")


@dataclass(frozen=True)
class DistOp:
    """A row-sharded general-sparsity operator: ``blocks`` holds one
    ``Csr`` per shard, rows ``[i·m_out, (i+1)·m_out)`` of the operator
    padded to ``d·m_out`` rows, its columns addressing the shard's window
    (module docstring). Before ``partition.place_hierarchy`` the blocks are
    host ``(col, val)`` ELL planes."""

    blocks: tuple
    mode: str                  # "halo" | "gather" | "replicated"
    halo: int                  # strip width h (halo mode)
    m_in: int                  # input rows per shard (padded)
    n_in: int                  # global (padded) input length
    n_in_real: int             # unpadded input length
    transport: str = "ppermute"
    tblocks: tuple = None      # replicated mode: per shard (its P rows)ᵀ

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode={self.mode!r}: one of {MODES}")
        check_transport(self.transport)

    @property
    def n_rows(self) -> int:
        """Global (padded) rows."""
        return sum(_block_rows(b) for b in self.blocks)


def _block_rows(b) -> int:
    return b.n_rows if isinstance(b, Csr) else int(b[0].shape[0])


@dataclass(frozen=True)
class DistLevel:
    a: object                  # SlabDia | DistOp (sharded) or a replicated
                               # operator
    dinv: object               # per-shard list, one tensor, or a float on
                               # a ConstDia level, f32 (Chebyshev)
    p: object                  # SlabProlong | GridProlong | DistOp | Csr
    r: object                  # SlabRestrict | GridRestrict | DistOp | Csr;
                               # None at a DistOp transition (Pᵀ is
                               # ``p.tblocks``)
    lmax: float                # f32 value
    s: object                  # Jacobi scale ω·dinv: per-shard list, one
                               # tensor, or a float on a ConstDia level
    sharded: bool              # this level's vectors are sharded
    next_sharded: bool = False  # level l + 1's vectors are sharded
    n_next: int = 0            # level l + 1's (padded or full) length


@dataclass(frozen=True)
class DistHierarchy:
    levels: Tuple[DistLevel, ...]
    coarse_chol: torch.Tensor  # replicated lower Cholesky factor
    params: AMGParams

    @property
    def nshards(self) -> int:
        for lv in self.levels:
            if isinstance(lv.a, (SlabDia, DistOp)):
                return len(lv.a.blocks)
        return 1


def _map(fn, *vs):
    """``fn`` per shard of sharded (list) arguments, or once on tensors."""
    if isinstance(vs[0], list):
        return [fn(*t) for t in zip(*vs)]
    return fn(*vs)


def _windows(op: DistOp, xs):
    """Per shard ``(window, x_base)``: the x its block's columns address,
    and where its row 0's own x sits in it (jacobi)."""
    if op.mode == "halo":
        h = op.halo
        if h == 0:
            return [(x, 0) for x in xs]
        exchange = (_exchange_planes_remote if op.transport == "remote"
                    else _exchange_planes)
        return [(w, h) for w in exchange(xs, 1, h, h)]
    if op.mode == "gather":
        xg = torch.cat(xs)
        return [(xg, i * op.m_in) for i in range(len(xs))]
    return [(xs, 0)] * len(op.blocks)    # the full (replicated) vector


def dist_op_apply(op: DistOp, xs, mode: str = "spmv", bs=None, ss=None,
                  vs=None):
    """Per shard the ``csr_spmv`` mode (spmv ``A·x``, residual ``b − A·x``,
    jacobi ``x + s ⊙ (b − A·x)``, correct ``v + A·x``) of its rows over its
    window: one launch per shard, after the exchange of ``op.mode``."""
    out = []
    for i, (blk, (w, base)) in enumerate(zip(op.blocks, _windows(op, xs))):
        if mode == "spmv":
            out.append(csr_spmv.spmv(blk, w))
        elif mode == "residual":
            out.append(csr_spmv.residual(blk, w, bs[i]))
        elif mode == "correct":
            out.append(csr_spmv.correct(blk, w, vs[i]))
        else:
            out.append(csr_spmv.jacobi(blk, w, bs[i], ss[i], x_base=base))
    return out


def restrict_to_replicated(p_op: DistOp, rs):
    """r_c = Pᵀ·r at a shard → replicated transition: per shard its Pᵀ
    block times its rows of r, summed over the shards in shard order."""
    return psum([csr_spmv.spmv(t, r) for t, r in zip(p_op.tblocks, rs)])


def dist_spmv(op, x, d: int):
    """y = A·x for every operator family: z-slab operators and ``DistOp``
    on shard lists, replicated ones on full vectors (``d``: the shard
    count, for a ``slice_in`` prolongation)."""
    if isinstance(op, SlabDia):
        return slab_apply(op, x)
    if isinstance(op, DistOp):
        return dist_op_apply(op, x)
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
    if isinstance(lv.a, SlabDia):
        return slab_apply(lv.a, x, "residual", bs=b)
    if isinstance(lv.a, DistOp):
        return dist_op_apply(lv.a, x, "residual", bs=b)
    return ops.residual(lv.a, x, b)


def _jacobi(lv: DistLevel, x, b):
    if isinstance(lv.a, SlabDia):
        return slab_apply(lv.a, x, "jacobi", bs=b, ss=lv.s)
    if isinstance(lv.a, DistOp):
        return dist_op_apply(lv.a, x, "jacobi", bs=b, ss=lv.s)
    return jacobi_sweep(lv.a, x, b, lv.s)


def _correct(lv: DistLevel, xc, x, d: int):
    """x + P·xc: the CSR kernel's correct mode on a ``DistOp`` (per shard)
    or a replicated ``Csr`` P, else the transfer and an add."""
    if isinstance(lv.p, DistOp):
        return dist_op_apply(lv.p, xc, "correct", vs=x)
    if isinstance(lv.p, Csr):
        return csr_spmv.correct(lv.p, xc, x)
    return _map(torch.add, x, dist_spmv(lv.p, xc, d))


def _smooth(lv: DistLevel, params: AMGParams, x, b, sweeps: int,
            x_is_zero: bool = False):
    """``sweeps`` smoothing sweeps of ``params.smoother`` (the single-device
    algebra, per shard); ``x_is_zero=True`` skips the first residual
    product exactly (A·0 ≡ 0)."""
    if x_is_zero and sweeps == 0:
        return _map(torch.zeros_like, b)
    if params.smoother == "chebyshev":
        return _chebyshev(lv, params, x, b, sweeps, x_is_zero)
    for k in range(sweeps):
        if k == 0 and x_is_zero:
            x = _map(lambda s, bb: s * bb, lv.s, b)
        else:
            x = _jacobi(lv, x, b)
    return x


def _chebyshev(lv: DistLevel, params: AMGParams, x, b, sweeps: int,
               x_is_zero: bool):
    """The Chebyshev recurrence of :func:`..amg.smoothers.chebyshev`, its
    products through :func:`dist_spmv` and its vector updates per shard."""
    theta, steps = chebyshev_coeffs(lv.lmax, params.cheby_degree,
                                    params.cheby_ratio)
    for k in range(sweeps):
        if k == 0 and x_is_zero:
            r = _map(lambda di, bb: di * bb, lv.dinv, b)
            d = _map(lambda t: t / theta, r)
            x = d
        else:
            r = _map(lambda di, t: di * t, lv.dinv, _residual(lv, x, b))
            d = _map(lambda t: t / theta, r)
            x = _map(torch.add, x, d)
        for c_d, c_r in steps:
            ad = dist_spmv(lv.a, d, 0)
            r = _map(lambda t, di, u: t - di * u, r, lv.dinv, ad)
            d = _map(lambda u, t: c_d * u + c_r * t, d, r)
            x = _map(torch.add, x, d)
    return x


def dist_vcycle(dh: DistHierarchy, b):
    """One cycle of type ``params.cycle`` with zero initial guess: b and the
    result are shard lists (or full vectors when level 0 is replicated)."""
    params = dh.params
    levels = dh.levels
    d = dh.nshards

    def coarse_visit(l, bc, cyc):
        """The coarse visits of :func:`..amg.vcycle.vcycle`, depth cap
        included."""
        if l == len(levels) or cyc == "v" or l > 8:
            return descend(l, bc, "v")
        x1 = descend(l, bc, cyc)
        r2 = _residual(levels[l], x1, bc)
        return _map(torch.add, x1,
                    descend(l, r2, "v" if cyc == "f" else cyc))

    def descend(l, bl, cyc):
        if l == len(levels):
            return coarse_solve(dh, bl)
        lv = levels[l]
        x = _smooth(lv, params, None, bl, params.nu_pre, x_is_zero=True)
        r = _residual(lv, x, bl)
        bc = (restrict_to_replicated(lv.p, r) if lv.r is None
              else dist_spmv(lv.r, r, d))
        xc = coarse_visit(l + 1, bc, cyc)
        x = _correct(lv, xc, x, d)
        return _smooth(lv, params, x, bl, params.nu_post)

    return descend(0, b, params.cycle)


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


def _pdots(pairs) -> torch.Tensor:
    """The global dots of several vector pairs as one tensor, the per-shard
    partials summed over the shards in one shard-order sum (one reduction
    point)."""
    if isinstance(pairs[0][0], list):
        return psum([torch.stack([torch.dot(u[i], v[i]) for u, v in pairs])
                     for i in range(len(pairs[0][0]))])
    return torch.stack([torch.dot(u, v) for u, v in pairs])


def _dist_pcg_pipelined_local(dh: DistHierarchy, b, tol: float,
                              maxiter: int) -> CGResult:
    """Sharded single-reduction PCG (Chronopoulos–Gear) from x = 0: γ, δ and
    ‖r‖² of the entry state in one shard-order sum and one host read per
    iteration (α, β on the host in float32). As the reference's, the exit
    test ‖r‖² > tol²·‖b‖² reads the entry residual, so the count can lag
    standard PCG's by one; the exit residual is recomputed exactly."""
    f = np.float32
    a = dh.levels[0].a
    d = dh.nshards
    x = _map(torch.zeros_like, b)
    r = b
    rn2 = f(pdot(b, b).item())          # ‖r₀‖² = ‖b‖²
    bnorm2 = f(1.0) if rn2 == 0 else rn2
    threshold = f(tol) * f(tol) * bnorm2
    u = dist_vcycle(dh, r)
    w = dist_spmv(a, u, d)
    p = _map(torch.zeros_like, b)
    s = _map(torch.zeros_like, b)
    history = [float(np.sqrt(rn2))]
    g_prev = a_prev = f(1.0)
    k = 0
    while rn2 > threshold and k < maxiter:
        gamma, delta, rn2 = _pdots([(r, u), (w, u), (r, r)]).cpu().numpy()
        if k:
            history.append(float(np.sqrt(rn2)))
        beta = f(0.0) if k == 0 else gamma / g_prev
        alpha = gamma / (delta - beta * gamma / a_prev)
        p = _map(lambda ui, pi: ui + float(beta) * pi, u, p)
        s = _map(lambda wi, si: wi + float(beta) * si, w, s)
        x = _map(lambda xi, pi: xi + float(alpha) * pi, x, p)
        r = _map(lambda ri, si: ri - float(alpha) * si, r, s)
        u = dist_vcycle(dh, r)
        w = dist_spmv(a, u, d)
        g_prev, a_prev = gamma, alpha
        k += 1
    rnorm = pnorm(r).item()
    if k:
        history.append(rnorm)
    return CGResult(x=x, iters=k, rel_residual=float(rnorm / np.sqrt(bnorm2)),
                    history=history)


def _as_shards(mesh, dh: DistHierarchy, v):
    if isinstance(v, list):
        return v, False
    if not dh.levels[0].sharded:
        return v.to(mesh.device), False
    return mesh.shard(v), True


def make_dist_solver(mesh, dh: DistHierarchy, tol: float = 1e-6,
                     maxiter: int = 200, variant: str = "standard"):
    """The sharded AMG-PCG: ``solve(dh, b[, tol]) → CGResult``. ``b`` is a
    shard list or a full vector (then x comes back full); ``tol`` is the
    default tolerance, overridable per call (the IR outer loop).
    ``variant="pipelined"`` is the single-reduction PCG: one shard sum and
    one host read per iteration."""
    if variant not in VARIANTS:
        raise ValueError(f"variant={variant!r} (supported: "
                         f"{', '.join(VARIANTS)})")
    local = (_dist_pcg_pipelined_local if variant == "pipelined"
             else _dist_pcg_local)

    def solve(dh, b, tol_s=None):
        bs, full = _as_shards(mesh, dh, b)
        res = local(dh, bs, tol if tol_s is None else tol_s, maxiter)
        return res._replace(x=mesh.gather(res.x)) if full else res

    return solve


def make_dist_vcycle(mesh, dh: DistHierarchy):
    """One sharded cycle: ``apply(dh, b) → z`` (full vectors or shard
    lists, as given)."""

    def apply(dh, b):
        bs, full = _as_shards(mesh, dh, b)
        z = dist_vcycle(dh, bs)
        return mesh.gather(z) if full else z

    return apply
