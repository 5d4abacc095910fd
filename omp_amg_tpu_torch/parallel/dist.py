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

On a mesh over processes (:mod:`.multihost`) a sharded operator holds
this rank's blocks only and carries the mesh (``mesh``, set at
placement): halo strips, gathered windows and the shard-order sums cross
processes through it, and every result is bitwise the one-process one. Its
collectives run on the host, so there :func:`make_dist_solver` runs the
eager block loop in place of CUDA graphs (``graph_stats`` says so).

Levels below the agglomeration threshold are replicated: one full vector,
the port's own single-device operators (``Csr`` or ``Dia``, ``ConstDia``,
the grid transfers) and kernels. Global dots and norms are sums over the
shards in shard order (:func:`.mesh.psum`), the only global reduction
points of PCG, so the counts do not depend on the partition. The pipelined
(single-reduction) PCG sums its three scalars over the shards at one point
per iteration. The smoothers (Jacobi, l1-Jacobi,
Chebyshev), the V, W and F cycles and both coarse solves are the
single-device ones, applied per shard, on either family. Both PCGs are
start and iteration steps over shard lists (:mod:`..solvers.graph`): on the
card :func:`make_dist_solver` captures blocks of them as CUDA graphs,
cached on the ``DistHierarchy``, and reads one flag per block.

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
from ..ops import csr_spmv, pcg_update
from ..ops import spmv as ops
from ..solvers import graph as G
from ..solvers.cg import VARIANTS, CGResult, host_copy, standard_program
from ..sparse.formats import Csr
from .mesh import first_shard, gather, psum
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
    mesh: object = None        # the mesh of the placed blocks (None: every
                               # shard's block is in ``blocks``)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode={self.mode!r}: one of {MODES}")
        check_transport(self.transport)

    @property
    def nshards(self) -> int:
        """Global shard count."""
        return self.mesh.size if self.mesh is not None else len(self.blocks)

    @property
    def n_rows(self) -> int:
        """Global (padded) rows (every block holds as many)."""
        return self.nshards * _block_rows(self.blocks[0])


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
    mesh: object = None        # the mesh it is placed on

    @property
    def nshards(self) -> int:
        """Global shard count."""
        for lv in self.levels:
            if isinstance(lv.a, (SlabDia, DistOp)):
                return lv.a.nshards
        return 1


_map = G.vmap      # fn per shard of sharded (list) arguments, or once on
                   # tensors


def _windows(op: DistOp, xs):
    """Per shard ``(window, x_base)``: the x its block's columns address,
    and where its row 0's own x sits in it (jacobi)."""
    if op.mode == "halo":
        h = op.halo
        if h == 0:
            return [(x, 0) for x in xs]
        exchange = (_exchange_planes_remote if op.transport == "remote"
                    else _exchange_planes)
        return [(w, h) for w in exchange(xs, 1, h, h, op.mesh)]
    if op.mode == "gather":
        xg = gather(xs, op.mesh)
        first = first_shard(op.mesh)
        return [(xg, (first + i) * op.m_in) for i in range(len(xs))]
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
    return psum([csr_spmv.spmv(t, r) for t, r in zip(p_op.tblocks, rs)],
                p_op.mesh)


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


def pdot(a, b, mesh=None) -> torch.Tensor:
    """Global dot (0-dim tensor on the device): per-shard dots summed in
    shard order (over every rank's shards on a process mesh)."""
    if isinstance(a, list):
        return psum([torch.dot(x, y) for x, y in zip(a, b)], mesh)
    return torch.dot(a, b)


def pnorm(a, mesh=None) -> torch.Tensor:
    return torch.sqrt(pdot(a, a, mesh))


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


def _coarse_visit(dh: DistHierarchy, l: int, bc, cyc: str):
    """The coarse visits of :func:`..amg.vcycle.vcycle`, depth cap
    included."""
    if l == len(dh.levels) or cyc == "v" or l > 8:
        return _descend(dh, l, bc, "v")
    x1 = _descend(dh, l, bc, cyc)
    r2 = _residual(dh.levels[l], x1, bc)
    return _map(torch.add, x1,
                _descend(dh, l, r2, "v" if cyc == "f" else cyc))


def _descend(dh: DistHierarchy, l: int, bl, cyc: str):
    if l == len(dh.levels):
        return coarse_solve(dh, bl)
    params, lv, d = dh.params, dh.levels[l], dh.nshards
    x = _smooth(lv, params, None, bl, params.nu_pre, x_is_zero=True)
    r = _residual(lv, x, bl)
    bc = (restrict_to_replicated(lv.p, r) if lv.r is None
          else dist_spmv(lv.r, r, d))
    xc = _coarse_visit(dh, l + 1, bc, cyc)
    x = _correct(lv, xc, x, d)
    return _smooth(lv, params, x, bl, params.nu_post)


def dist_vcycle(dh: DistHierarchy, b):
    """One cycle of type ``params.cycle`` with zero initial guess: b and the
    result are shard lists (or full vectors when level 0 is replicated).
    The recursion is module functions, as :func:`..amg.vcycle.vcycle`'s
    (no closure cycle keeps ``dh`` alive)."""
    return _descend(dh, 0, b, dh.params.cycle)


def _programs(dh: DistHierarchy, maxiter: int, variant: str):
    """The sharded PCG of ``variant`` as start and iteration steps
    (:mod:`..solvers.graph`) from x = 0, on shard lists (or full vectors
    when level 0 is replicated)."""
    a = dh.levels[0].a
    d = dh.nshards
    mesh = dh.mesh

    def precond(r):
        return dist_vcycle(dh, r)

    def apply_a(v):
        return dist_spmv(a, v, d)

    if variant == "pipelined":
        return _pipelined_program(apply_a, precond, maxiter, mesh)
    return standard_program(apply_a, precond, maxiter,
                            dot=lambda u, v: pdot(u, v, mesh),
                            norm=lambda u: pnorm(u, mesh), vmap=_map)


def _pdots(pairs, mesh=None) -> torch.Tensor:
    """The global dots of several vector pairs as one tensor, the per-shard
    partials summed over the shards in one shard-order sum (one reduction
    point)."""
    if isinstance(pairs[0][0], list):
        return psum([torch.stack([torch.dot(u[i], v[i]) for u, v in pairs])
                     for i in range(len(pairs[0][0]))], mesh)
    return torch.stack([torch.dot(u, v) for u, v in pairs])


def _pipelined_program(apply_a, precond, maxiter: int,
                       mesh=None) -> G.Program:
    """Sharded single-reduction PCG (Chronopoulos–Gear): γ, δ and ‖r‖² of
    the entry state in one shard-order sum per iteration, α and β from them
    as f32 device scalars. As the reference's, the exit test ‖r‖² >
    tol²·‖b‖² reads the entry residual, so the count can lag standard
    PCG's by one; the exit residual is recomputed exactly at the end."""

    def start(b, tol, x0):
        if x0 is not None:
            raise ValueError("the sharded PCG starts from x = 0")
        rn2 = pdot(b, b, mesh)             # ‖r₀‖² = ‖b‖²
        bnorm2 = G.guard(rn2)
        u = precond(b)
        hist, k = G.new_history(maxiter, torch.sqrt(rn2))
        one = torch.ones_like(rn2)
        return dict(x=_map(torch.zeros_like, b), r=_map(torch.clone, b),
                    u=u, w=apply_a(u),
                    p=_map(torch.zeros_like, b), s=_map(torch.zeros_like, b),
                    g_prev=one, a_prev=one.clone(), k=k,
                    active=(rn2 > tol * tol * bnorm2) & (k < maxiter),
                    hist=hist, thr=tol * tol * bnorm2, bnorm2=bnorm2)

    def step(st, masked):
        sel = G.selector(st["active"], masked)
        k0 = st["k"]
        gamma, delta, rn2 = _pdots([(st["r"], st["u"]), (st["w"], st["u"]),
                                    (st["r"], st["r"])], mesh).unbind()
        G.record(st["hist"], k0, torch.sqrt(rn2), st["active"] & (k0 > 0))
        beta = torch.where(k0 == 0, torch.zeros_like(gamma),
                           gamma / st["g_prev"])
        alpha = gamma / (delta - beta * gamma / st["a_prev"])
        flag = st["active"] if masked else None
        x, r, p, s = st["x"], st["r"], st["p"], st["s"]
        _map(lambda *v: pcg_update.p_update(*v, beta, flag), p, st["u"])
        _map(lambda *v: pcg_update.p_update(*v, beta, flag), s, st["w"])
        _map(lambda *v: pcg_update.xr(*v, alpha, flag), x, r, p, s)
        u = precond(r)
        w = apply_a(u)
        k, active = G.advance(st, maxiter, rn2 > st["thr"])
        return dict(st, u=sel(u, st["u"]), w=sel(w, st["w"]),
                    g_prev=sel(gamma, st["g_prev"]),
                    a_prev=sel(alpha, st["a_prev"]), k=k, active=active)

    def finish(st):
        st = dict(st, rnorm=pnorm(st["r"], mesh))
        k, history, rnorm, bnorm2 = host_copy(st, "rnorm", "bnorm2")
        history = history[:k] + [float(rnorm)] if k else history[:1]
        return CGResult(x=st["x"], iters=k,
                        rel_residual=float(float(rnorm) / np.sqrt(bnorm2)),
                        history=history)

    return G.Program(start, step, finish)


def _as_shards(mesh, dh: DistHierarchy, v):
    if isinstance(v, list):
        return v, False
    if not dh.levels[0].sharded:
        return v.to(mesh.device), False
    return mesh.shard(v), True


def make_dist_solver(mesh, dh: DistHierarchy, tol: float = 1e-6,
                     maxiter: int = 200, variant: str = "standard",
                     graph: bool = True):
    """The sharded AMG-PCG: ``solve(dh, b[, tol]) → CGResult``. ``b`` is a
    shard list or a full vector (then x comes back full); ``tol`` is the
    default tolerance, overridable per call (the IR outer loop).
    ``variant="pipelined"`` is the single-reduction PCG: one shard sum per
    iteration. ``graph=True``: captured blocks on CUDA, cached on the
    ``DistHierarchy`` passed to ``solve`` (the per-call ``tol`` an input of
    the graphs), the eager block loop on CPU and on a process mesh (its
    collectives run on the host and cannot be captured; the runner is
    cached on the hierarchy all the same, and ``graph_stats`` reports it
    with ``captured: False``); ``graph=False``: the per-iteration loop."""
    if variant not in VARIANTS:
        raise ValueError(f"variant={variant!r} (supported: "
                         f"{', '.join(VARIANTS)})")

    def solve(dh, b, tol_s=None):
        bs, full = _as_shards(mesh, dh, b)
        leaves = bs if isinstance(bs, list) else [bs]
        key = ("dist", variant, tuple(tuple(t.shape) for t in leaves),
               leaves[0].dtype, int(maxiter))
        res = G.run(_programs(dh, maxiter, variant), bs,
                    tol if tol_s is None else tol_s, graph=graph, owner=dh,
                    key=key, capture=mesh.world == 1)
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
