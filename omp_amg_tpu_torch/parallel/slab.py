"""Z-slab structured distributed operators (counterpart of
``omp_amg_tpu/parallel/slab.py``).

Every level of a structured hierarchy is a DIA stencil on a tensor grid, so
sharding the leading grid axis (z-planes) over the mesh makes every
distributed primitive a plane exchange:

- ``SlabDia``: a level operator as per-shard DIA blocks ``(ndiag, n_loc)``.
  Its SpMV exchanges ``hl``/``hr`` boundary planes (non-circular: zeros
  beyond the global ends, the Dirichlet masked-zero invariant) and runs one
  ``dia_spmv`` launch per shard over the exchanged window;
- ``SlabProlong``/``SlabRestrict``: the tensor-product grid transfers
  applied slab-locally; only the z-axis needs one neighbour plane.

A sharded vector is a list of per-shard tensors (:mod:`.mesh`): this
process's shards, every shard on one process. The
operators carry their mesh (``mesh``, set at placement; None: every shard
in this process), and the strips that cross a process boundary travel
through it. The halo transports are ``"ppermute"`` (plain strip copies, the
default, as in the reference) and ``"remote"``: the hand-written
``remote_halo`` kernel (``ops/remote_halo.py``), the counterpart of the
reference's Pallas ``"pallas"`` transport with its zero mask and
concatenation, which writes every local shard's window in one launch; on a
process mesh it reads the neighbours' strips from their CUDA IPC mailboxes
(``ShardMesh.remote_windows``).

The reference splits each product into interior and boundary rows so that
XLA can overlap the interior with the exchange; per row both sum the same
terms in the same order, so the port computes all rows from the exchanged
window in one pass.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..amg.structured import _prolong_axis, _restrict_axis
from ..ops import dia_spmv
from ..ops.remote_halo import remote_halo_window
from ..sparse.formats import Dia
from .mesh import first_shard, gather, outer_strips, spans

TRANSPORTS = ("ppermute", "remote")


def _prod(t) -> int:
    return int(np.prod(t, dtype=np.int64)) if len(t) else 1


def check_transport(transport: str) -> str:
    if transport == "pallas":
        raise ValueError('transport="pallas" is the reference\'s TPU name; '
                         'the port\'s halo kernel is transport="remote"')
    if transport not in TRANSPORTS:
        raise ValueError(f"transport={transport!r}: one of {TRANSPORTS}")
    return transport


@dataclass(frozen=True)
class SlabDia:
    """DIA operator sharded by z-plane slabs: ``data`` holds one
    ``(ndiag, n_loc)`` block per shard, rows ``[i·n_loc, (i+1)·n_loc)``
    (before ``partition.place_hierarchy``: one global ``(ndiag, n)``
    tensor)."""

    data: object                       # tuple of per-shard tensors
    offsets: Tuple[int, ...]
    dims: Tuple[int, ...]              # GLOBAL grid extents (C order)
    hl: int = 0                        # left halo planes
    hr: int = 0                        # right halo planes
    transport: str = "ppermute"
    mesh: object = None                # the mesh of the placed blocks

    def __post_init__(self):
        check_transport(self.transport)

    @property
    def nshards(self) -> int:
        """Global shard count."""
        return self.mesh.size if self.mesh is not None else len(self.blocks)

    @property
    def plane(self) -> int:
        return _prod(self.dims[1:])

    @property
    def n_rows(self) -> int:
        """Global rows."""
        return _prod(self.dims)

    @functools.cached_property
    def blocks(self) -> Tuple[Dia, ...]:
        """The per-shard ``Dia`` operands of the kernel."""
        if isinstance(self.data, torch.Tensor):
            raise ValueError("SlabDia not placed on a mesh "
                             "(partition.place_hierarchy)")
        return tuple(Dia(data=t, offsets=self.offsets) for t in self.data)


@dataclass(frozen=True)
class SlabProlong:
    """Tensor-product prolongation applied on z-slabs."""

    fine_shape: Tuple[int, ...]
    coarse_shape: Tuple[int, ...]
    coarsened: Tuple[bool, ...]
    slice_in: bool = False   # input replicated: each shard slices its window
    mesh: object = None


@dataclass(frozen=True)
class SlabRestrict:
    """Transpose transfer on z-slabs."""

    fine_shape: Tuple[int, ...]
    coarse_shape: Tuple[int, ...]
    coarsened: Tuple[bool, ...]
    gather_out: bool = False  # return the full (replicated) coarse vector
    mesh: object = None


def slab_halos(offsets, dims) -> Tuple[int, int]:
    """(hl, hr) halo plane counts for a DIA offset set on ``dims``.

    Truncating division gives the minimal plane halo: the in-plane remainder
    may push a flat read one plane further, but only where the tap crosses a
    grid-row boundary, exactly where the masked-zero invariant guarantees
    the stored value is 0 (and the window's guard reads 0 there).
    """
    plane = _prod(dims[1:])
    pzs = [int(o / plane) for o in offsets] or [0]  # trunc toward zero
    return max(0, -min(pzs)), max(0, max(pzs))


def _exchange_planes(xs, plane: int, hl: int, hr: int, mesh=None):
    """Per shard ``[left strip | x | right strip]``, non-circular: shards
    with no neighbour (the global ends) receive zeros. On a process mesh
    the strips beyond this rank's shards come from its neighbours."""
    d = len(xs)
    nl, nr = hl * plane, hr * plane
    left, right = outer_strips(xs, nl, nr, mesh)
    out = []
    for i, x in enumerate(xs):
        parts = [x]
        if nl:
            parts.insert(0, xs[i - 1][x.numel() - nl:] if i > 0
                         else left if left is not None else x.new_zeros(nl))
        if nr:
            parts.append(xs[i + 1][:nr] if i < d - 1
                         else right if right is not None
                         else x.new_zeros(nr))
        out.append(torch.cat(parts) if len(parts) > 1 else x)
    return out


def _exchange_planes_remote(xs, plane: int, hl: int, hr: int, mesh=None):
    """:func:`_exchange_planes` through the ``remote_halo`` kernel: every
    shard's window, the global ends zero, in one launch (on a process mesh
    through the neighbours' IPC mailboxes)."""
    if hl == 0 and hr == 0:
        return list(xs)
    if spans(mesh):
        return list(mesh.remote_windows(xs, hl * plane, hr * plane)
                    .unbind(0))
    if len(xs) == 1:
        return _exchange_planes(xs, plane, hl, hr)
    return list(remote_halo_window(xs, hl * plane, hr * plane).unbind(0))


def slab_windows(op: SlabDia, xs, transport: str):
    """Per shard ``(window, base)``: the x its local rows read, with row 0's
    own x at ``window[base]``. The exchanged ``[left halo | x | right
    halo]``; or, for a slab thinner than its halo (tiny coarse levels), the
    reconstructed full vector at the shard's first row (the reference's
    ``_slab_spmv_full``)."""
    n_loc = xs[0].numel()
    plane = op.plane
    if max(op.hl, op.hr) * plane > n_loc:
        xg = gather(xs, op.mesh)
        first = first_shard(op.mesh)
        return [(xg, (first + i) * n_loc) for i in range(len(xs))]
    exchange = (_exchange_planes_remote if transport == "remote"
                else _exchange_planes)
    base = op.hl * plane
    return [(w, base) for w in exchange(xs, plane, op.hl, op.hr, op.mesh)]


def slab_apply(op: SlabDia, xs, mode: str = "spmv", bs=None, ss=None):
    """Per shard the ``dia_spmv`` mode (spmv ``A·x``, residual ``b − A·x``,
    jacobi ``x + s ⊙ (b − A·x)``) of the local rows, after the plane
    exchange of ``op.transport``; one kernel launch per shard."""
    out = []
    wins = slab_windows(op, xs, op.transport)
    for i, (blk, (w, base)) in enumerate(zip(op.blocks, wins)):
        if mode == "spmv":
            out.append(dia_spmv.spmv(blk, w, x_base=base))
        elif mode == "residual":
            out.append(dia_spmv.residual(blk, w, bs[i], x_base=base))
        else:
            out.append(dia_spmv.jacobi(blk, w, bs[i], ss[i], x_base=base))
    return out


def slab_spmv(op: SlabDia, xs):
    """ys = (A @ x) per shard, with the plane halo exchange."""
    return slab_apply(op, xs)


def slab_prolong(p: SlabProlong, xc, d: int):
    """Fine shards of P @ x_coarse: ``xc`` is the coarse shard list, or the
    replicated full vector when ``slice_in`` (``d`` shards). z first (one
    coarse-plane halo from the right neighbour), then the within-plane
    axes."""
    cs, fs, cz = p.coarse_shape, p.fine_shape, p.coarsened
    cplane = _prod(cs[1:])
    if p.slice_in:
        nzc_l = cs[0] // d
        xfull = torch.nn.functional.pad(xc, (0, cplane)) if cz[0] else xc
        span = (nzc_l + 1 if cz[0] else nzc_l) * cplane
        first = first_shard(p.mesh)
        local = p.mesh.local if p.mesh is not None else d
        vs = [xfull[i * nzc_l * cplane: i * nzc_l * cplane + span]
              .reshape(-1, *cs[1:]) for i in range(first, first + local)]
    else:
        vs = [x.reshape(-1, *cs[1:]) for x in xc]
        if cz[0]:
            # right halo: my fine plane 2j+1 at the slab top needs c(j+1)
            _, right = outer_strips(xc, 0, cplane, p.mesh)
            last = (right.reshape(1, *cs[1:]) if right is not None
                    else torch.zeros_like(vs[-1][:1]))
            n = len(vs)
            vs = [torch.cat([v, vs[i + 1][:1] if i + 1 < n else last])
                  for i, v in enumerate(vs)]
    out = []
    for v in vs:
        if cz[0]:
            nzc_l = v.shape[0] - 1
            a, b = v[:nzc_l], v[1:]
            x = torch.stack([a, 0.5 * (a + b)], dim=1).reshape(
                2 * nzc_l, *cs[1:])
        else:
            x = v
        for ax in range(1, len(fs)):
            if cz[ax]:
                x = _prolong_axis(x, ax, fs[ax])
        out.append(x.reshape(-1).contiguous())
    return out


def slab_restrict(r: SlabRestrict, xf):
    """Coarse shards of Pᵀ @ x_fine: within-plane axes first (so the one
    exchanged z-strip is coarse-plane sized), then z with a left-neighbour
    plane. ``gather_out`` returns the full replicated coarse vector."""
    fs, cs, cz = r.fine_shape, r.coarse_shape, r.coarsened
    xs = []
    for x in xf:
        x = x.reshape(-1, *fs[1:])
        for ax in range(1, len(fs)):
            if cz[ax]:
                x = _restrict_axis(x, ax, cs[ax])
        xs.append(x)
    first_strip = torch.zeros_like(xs[0][:1])
    if cz[0]:
        left, _ = outer_strips([x.reshape(-1) for x in xs],
                               xs[0][0].numel(), 0, r.mesh)
        if left is not None:
            first_strip = left.reshape(first_strip.shape)
    out = []
    for i, x in enumerate(xs):
        if cz[0]:
            strip = xs[i - 1][-1:] if i > 0 else first_strip
            ext = torch.cat([strip, x])
            nzc_l = x.shape[0] // 2
            even = ext[1::2]                   # f(2j)
            lft = ext[0::2][:nzc_l]            # f(2j-1)
            rgt = ext[2::2]                    # f(2j+1)
            x = even + 0.5 * (lft + rgt)
        out.append(x.reshape(-1).contiguous())
    return gather(out, r.mesh) if r.gather_out else out
