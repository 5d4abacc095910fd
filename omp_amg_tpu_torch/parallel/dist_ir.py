"""Certified distributed solve: f64 iterative refinement over the mesh
(counterpart of ``omp_amg_tpu/parallel/dist_ir.py``).

The defect-correction outer loop keeps x and b in float64 on the shards and
computes the true residual r = b − A·x there, in native float64 (the
reference emulates it with double-float32 pairs, ``ops/df64.py``; the card
has f64 arithmetic, so the port does not carry that module). A is the
user's operator in float64 (:func:`fine_f64`: built once, per shard, in the
level-0 layout), never the hierarchy's f32 or bf16 level-0 blocks: those
round a value that f32 does not hold exactly, and a residual formed from
them certifies a solution of another operator. The product is plain and
deterministic: DIA taps in ascending order on a z-slab level, ELL slots in
the row's column order on a general-sparsity level, each a fixed sum per
row (no atomics), after the plain exchange. It runs once per outer pass
(2–3 per solve), not per V-cycle. The norm is one shard-order sum; the
unit residual goes to the f32 sharded AMG-PCG (:mod:`.dist`) at an
adaptive tolerance, an input of its captured graphs. On the card b and x
travel through pinned host buffers, kept per solver and reused across
solves, with asynchronous copies. On a mesh over processes every rank holds
the f64 blocks of its own shards, the norm is the cross-process
shard-order sum, and x comes back whole on every rank.

The reference forms this residual from its f32 level-0 values on both mesh
paths (``omp_amg_tpu/parallel/dist_ir.py:41``, ``:94``); it also rescales
the norm of a fully replicated fine level by the shard count, because each
of its shards holds the whole vector. The port holds a replicated vector
once, so neither applies.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..ops import ir_f64
from ..solvers.ir import IRResult
from .dist import DistHierarchy, DistOp, _windows, make_dist_solver, pdot
from .mesh import first_shard
from .slab import SlabDia, slab_windows


@dataclass(frozen=True)
class SlabF64:
    """Level 0 of a z-slab hierarchy in float64: per shard a ``Dia`` of its
    columns of the user's DIA planes ``(ndiag, n_loc)``, under the user's
    offsets."""

    op: SlabDia                 # the hierarchy's level-0 operator (layout)
    blocks: tuple


@dataclass(frozen=True)
class EllF64:
    """Level 0 of a general-sparsity hierarchy in float64: per shard (or,
    replicated, once) ELL planes ``(K, rows)`` of the user's operator,
    columns in the level-0 operator's window convention (padding: value 0,
    column 0)."""

    op: object                  # DistOp, or None for a replicated level
    cols: tuple                 # int64 (K, rows) per block
    vals: tuple                 # float64 (K, rows) per block


def _host_csr(a):
    import scipy.sparse as sp

    from ..amg.hierarchy import fine_host_operator

    m = sp.csr_matrix(fine_host_operator(a), dtype=np.float64)
    m.sort_indices()
    return m


def _ell_f64(m, col_shift, n_rows: int, device):
    """(cols, vals) planes ``(K, n_rows)`` of the CSR rows ``m`` (padded
    with empty rows to ``n_rows``), each column moved by ``col_shift``."""
    from ..sparse.formats import ell_planes_from_scipy

    col, val, _ = ell_planes_from_scipy(m, dtype=np.float64)
    valid = val != 0
    col = np.where(valid, col.astype(np.int64) + col_shift, 0)
    pad = n_rows - col.shape[0]
    col = np.pad(col, ((0, pad), (0, 0)))
    val = np.pad(val, ((0, pad), (0, 0)))
    return (torch.from_numpy(np.ascontiguousarray(col.T)).to(device),
            torch.from_numpy(np.ascontiguousarray(val.T)).to(device))


def fine_f64(a, dh: DistHierarchy, device):
    """The user's fine operator ``a`` (a ``Dia``, numpy or torch planes, or
    a scipy matrix) in float64 on ``device``, in the layout of ``dh``'s
    level 0: per-shard DIA blocks of a z-slab level, per-shard ELL planes
    of a ``DistOp`` level, one set of ELL planes for a replicated level."""
    from ..sparse.formats import Dia, _numpy, dia_planes_from_scipy

    a0 = dh.levels[0].a
    if isinstance(a0, SlabDia):
        if isinstance(a, Dia):
            offsets = tuple(int(o) for o in a.offsets)
            data = np.asarray(_numpy(a.data), np.float64)
        else:
            offsets, data = dia_planes_from_scipy(_host_csr(a))
            offsets = tuple(int(o) for o in offsets)
        if data.shape[1] != a0.n_rows:
            raise ValueError(f"an operator of {data.shape[1]} rows for a "
                             f"level 0 of {a0.n_rows}")
        first = first_shard(a0.mesh)
        chunks = np.array_split(data, a0.nshards, axis=1)
        return SlabF64(op=a0, blocks=tuple(
            Dia(data=torch.from_numpy(np.ascontiguousarray(c)).to(device),
                offsets=offsets)
            for c in chunks[first:first + len(a0.blocks)]))
    m = _host_csr(a)
    if not isinstance(a0, DistOp):
        if m.shape[0] != a0.n_rows:
            raise ValueError(f"an operator of {m.shape[0]} rows for a "
                             f"level 0 of {a0.n_rows}")
        c, v = _ell_f64(m, 0, m.shape[0], device)
        return EllF64(op=None, cols=(c,), vals=(v,))
    d = a0.nshards
    m_out = a0.n_rows // d
    if not (m.shape[0] <= a0.n_rows < m.shape[0] + d):
        raise ValueError(f"an operator of {m.shape[0]} rows for a level 0 "
                         f"of {a0.n_rows} padded rows")
    cols, vals = [], []
    first = first_shard(a0.mesh)
    for i in range(first, first + len(a0.blocks)):
        rows = m[min(i * m_out, m.shape[0]):min((i + 1) * m_out,
                                                m.shape[0])]
        shift = a0.halo - i * a0.m_in if a0.mode == "halo" else 0
        c, v = _ell_f64(rows, shift, m_out, device)
        cols.append(c)
        vals.append(v)
    return EllF64(op=a0, cols=tuple(cols), vals=tuple(vals))


def _ell_apply_f64(cols, vals, w):
    """y = A·w in float64, the ELL slots summed in order (a fixed sum per
    row)."""
    y = torch.zeros(cols.shape[1], dtype=torch.float64, device=w.device)
    for c, v in zip(cols, vals):
        y = y + v * w.index_select(0, c)
    return y


def _f64_spmv(a64, xs):
    """y = A·x in float64: per shard over its plain-exchanged window, or on
    the full vector of a replicated level."""
    if isinstance(a64, SlabF64):
        return [ir_f64.spmv(blk, w, x_base=base)
                for blk, (w, base) in zip(a64.blocks,
                                          slab_windows(a64.op, xs,
                                                       "ppermute"))]
    if a64.op is None:
        return _ell_apply_f64(a64.cols[0], a64.vals[0], xs)
    plain = replace(a64.op, transport="ppermute")   # f64 strips
    return [_ell_apply_f64(c, v, w) for c, v, (w, _) in
            zip(a64.cols, a64.vals, _windows(plain, xs))]


def _mesh(a64):
    return getattr(a64.op, "mesh", None)


def _residual_local(a64, bs, xs):
    """One IR refresh: r = b − A·x (f64), its norm (a python float) and the
    unit residual r/‖r‖ in f32 (shard lists, or full vectors)."""
    ys = _f64_spmv(a64, xs)
    if isinstance(bs, list):
        rs = [b - y for b, y in zip(bs, ys)]
    else:
        rs = bs - ys
    rnorm = float(torch.sqrt(pdot(rs, rs, _mesh(a64))).item())
    safe = rnorm if rnorm != 0 else 1.0
    if isinstance(rs, list):
        return [(r / safe).float() for r in rs], rnorm
    return (rs / safe).float(), rnorm


def supports_df64(dh: DistHierarchy) -> bool:
    """True when the fine level has a distributed f64 residual: a z-slab or
    a ``DistOp`` fine operator in halo or gather mode, or an unsharded
    (replicated) fine level (the name is the reference's; the port's
    residual is native f64)."""
    lv0 = dh.levels[0]
    if isinstance(lv0.a, SlabDia):
        return True
    if isinstance(lv0.a, DistOp):
        return lv0.a.mode in ("halo", "gather")
    return not lv0.sharded


class PinnedStage:
    """Pinned host buffers by name, reused while the shape holds: the b
    and x copies of a solver on the card (``non_blocking`` both ways)."""

    def __init__(self):
        self.bufs = {}

    def buffer(self, name: str, shape, dtype=torch.float64) -> torch.Tensor:
        buf = self.bufs.get(name)
        if buf is None or buf.shape != tuple(shape) or buf.dtype != dtype:
            buf = self.bufs[name] = torch.empty(shape, dtype=dtype,
                                                pin_memory=True)
        return buf

    def to_device(self, a: np.ndarray, device) -> torch.Tensor:
        """The host array ``a`` on ``device`` through the pinned buffer."""
        buf = self.buffer("in", a.shape)
        buf.numpy()[...] = a
        return buf.to(device, non_blocking=True)

    def to_host(self, t: torch.Tensor) -> np.ndarray:
        """A device vector as a host array (a copy: the buffer is reused by
        the next solve)."""
        buf = self.buffer("out", t.shape, t.dtype)
        buf.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        return buf.numpy().copy()


def make_dist_ir_solver(mesh, dh: DistHierarchy, a64, tol: float = 1e-8,
                        inner_tol: float = 1e-6, maxiter: int = 200,
                        max_outer: int = 8, variant: str = "standard",
                        graph: bool = True):
    """The certified distributed solver: ``solve(dh, b) → IRResult`` for a
    host f64 right-hand side ``b`` (level 0's global, padded rows); x comes
    back as a host f64 array. ``a64`` is the user's operator in float64 in
    ``dh``'s level-0 layout (:func:`fine_f64`); ``variant``, ``graph``: the
    inner PCG's (:func:`.dist.make_dist_solver`)."""
    if not supports_df64(dh):
        raise NotImplementedError("the certified distributed solve needs a "
                                  "z-slab, halo, gather or replicated fine "
                                  "level")
    if not isinstance(a64, (SlabF64, EllF64)):
        raise TypeError("a64: the fine operator from fine_f64")
    inner = make_dist_solver(mesh, dh, tol=inner_tol, maxiter=maxiter,
                             variant=variant, graph=graph)
    sharded = dh.levels[0].sharded
    stage = PinnedStage() if mesh.device.type == "cuda" else None

    def solve(dh_in, b) -> IRResult:
        b = np.asarray(b, np.float64)
        bnorm = float(np.linalg.norm(b))
        if bnorm == 0:
            return IRResult(np.zeros_like(b), 0, [], 0.0, [])
        bt = (torch.from_numpy(b) if stage is None
              else stage.to_device(b, mesh.device))
        bs = mesh.shard(bt) if sharded else bt.to(mesh.device)
        xs = ([torch.zeros_like(t) for t in bs] if sharded
              else torch.zeros_like(bs))
        inner_iters, histories = [], []
        rel = 1.0
        for outer in range(max_outer + 1):
            r_unit, rnorm = _residual_local(a64, bs, xs)
            rel = rnorm / bnorm
            if rel <= tol or outer == max_outer:
                break
            tau = max(inner_tol, 0.3 * tol / rel)
            res = inner(dh_in, r_unit, tau)
            inner_iters.append(res.iters)
            histories.append(res.history)
            if sharded:
                xs = [x + rnorm * e.double() for x, e in zip(xs, res.x)]
            else:
                xs = xs + rnorm * res.x.double()
        x = mesh.gather(xs) if sharded else xs
        x = x.cpu().numpy() if stage is None else stage.to_host(x)
        return IRResult(x, len(inner_iters), inner_iters, rel, histories)

    return solve
