"""Host-side partition of a hierarchy over a shard mesh (counterpart of
``omp_amg_tpu/parallel/partition.py``).

A structured hierarchy shards by z-plane slabs while its leading grid axis
splits evenly over the mesh (and evenly into coarse pairs when that axis is
coarsened) and the per-shard block stays at or above ``agg_rows_per_dev``;
the coarser levels are replicated (agglomeration). Any other hierarchy (the
classical PMIS one, or a structured one whose level 0 cannot shard by
slabs) takes the general-sparsity partition, from host ELL planes, with the
reference's rules:

- a level's rows split into ``ndev`` contiguous blocks of ``m = ⌈n /
  ndev⌉`` rows, padded to ``ndev·m`` (``dinv`` padded with 1.0, so the
  padded rows of every vector stay 0);
- a level is sharded while ``m ≥ agg_rows_per_dev`` (monotone: once a level
  replicates, the coarser ones do) and ``ndev > 1``; on one shard every
  level is sharded; the dense coarse level is always replicated;
- per operator the halo width h is the widest reach of a valid column out
  of its shard's input block; the columns are localised to the window
  ``[h | m_in | h]`` (``halo`` mode), or kept global when h > m_in
  (``gather``) or when the input is replicated (the transition P,
  ``replicated``, with its per-shard Pᵀ blocks);
- the replicated levels hold single-device ``Csr`` operators.

``partition_hierarchy`` decides the layout and keeps host arrays;
``place_hierarchy`` puts every block on the mesh's device (z-slab arrays
split into their ``d`` blocks; ELL blocks as ``Csr``, in bf16 when that
cast is lossless on every block, else f32; int32 columns). On a mesh
over processes it places this rank's blocks only (the decisions above are
taken on the whole host partition, which every rank holds); replicated
levels and the coarse factor are placed whole on every rank. Vectors stay
global: ``pad_vector`` pads the full vector, ``mesh.shard`` takes the
rank's blocks and ``mesh.gather`` returns the full vector on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..amg.hierarchy import Hierarchy, jacobi_scale
from ..amg.structured import GridProlong, GridRestrict, prolong_to_scipy
from ..sparse.formats import (
    ConstDia, Csr, Dia, bf16_lossless, const_to_dia, csr_from_ell,
    ell_planes_from_dia, ell_planes_from_scipy, tile_to_csr,
)
from .dist import DistHierarchy, DistLevel, DistOp, _block_rows
from .slab import SlabDia, SlabProlong, SlabRestrict, slab_halos


@dataclass(frozen=True)
class HostEll:
    """A replicated operator as host ELL planes, before placement."""

    col: np.ndarray
    val: np.ndarray
    n_cols: int

    @property
    def n_rows(self) -> int:
        return int(self.col.shape[0])


def _structured_dias(hier: Hierarchy):
    """Per-level device ``Dia`` operators of a structured hierarchy (None if
    any level is not a banded grid operator with grid transfers)."""
    dias = []
    for lv in hier.levels:
        a = const_to_dia(lv.a) if isinstance(lv.a, ConstDia) else lv.a
        if not isinstance(a, Dia) or a.dims is None \
                or not isinstance(lv.p, GridProlong):
            return None
        dias.append(a)
    return dias


def _partition_structured(hier: Hierarchy, ndev: int, agg_rows_per_dev: int,
                          transport: str = "ppermute"):
    """Z-slab partition; None when level 0 itself cannot shard."""
    dias = _structured_dias(hier)
    if dias is None:
        return None
    nlev = len(hier.levels)
    sizes = [a.n_rows for a in dias] + [int(hier.coarse_chol.shape[0])]

    sharded = []
    prev = True
    for l in range(nlev):
        a, p = dias[l], hier.levels[l].p
        nz = a.dims[0]
        ok = prev and nz % ndev == 0 and (
            ndev == 1 or sizes[l] // ndev >= agg_rows_per_dev)
        if ok and p.coarsened[0]:
            ok = nz % (2 * ndev) == 0
        sharded.append(bool(ok))
        prev = ok
    sharded.append(False)  # dense coarse level always replicated
    if not sharded[0]:
        return None

    levels = []
    for l, lv in enumerate(hier.levels):
        a = dias[l]
        p_g = lv.p
        if sharded[l]:
            hl, hr = slab_halos(a.offsets, a.dims)
            a_op = SlabDia(data=a.data, offsets=tuple(a.offsets),
                           dims=tuple(a.dims), hl=hl, hr=hr,
                           transport=transport)
            trans = not sharded[l + 1]
            shape = dict(fine_shape=p_g.fine_shape,
                         coarse_shape=p_g.coarse_shape,
                         coarsened=p_g.coarsened)
            p_op = SlabProlong(**shape, slice_in=trans)
            r_op = SlabRestrict(**shape, gather_out=trans)
            s = lv.s if isinstance(lv.s, torch.Tensor) else torch.full(
                (a.n_rows,), lv.s, dtype=torch.float32)
            dinv = torch.from_numpy(lv.dinv)
        else:
            a_op, p_op, r_op, s, dinv = lv.a, lv.p, lv.r, lv.s, lv.dinv_dev
        levels.append(DistLevel(
            a=a_op, dinv=dinv, p=p_op, r=r_op, lmax=lv.lmax, s=s,
            sharded=bool(sharded[l])))
    return DistHierarchy(levels=tuple(levels), coarse_chol=hier.coarse_chol,
                         params=hier.params)


def _pad_rows(arr: np.ndarray, n_to: int, fill=0):
    if arr.shape[0] == n_to:
        return arr
    pad = np.full((n_to - arr.shape[0],) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def _transpose_block(col: np.ndarray, val: np.ndarray, n_cols: int):
    """(col, val) ELL planes of the transpose of one block of rows (global
    columns < ``n_cols``): its columns are the block's rows, its rows the
    block's columns, each row in ascending column order."""
    import scipy.sparse as sp

    m, k = col.shape
    valid = val != 0
    rows = np.repeat(np.arange(m, dtype=np.int64), k).reshape(m, k)
    t = sp.csr_matrix((val[valid].astype(np.float64),
                       (col[valid].astype(np.int64), rows[valid])),
                      shape=(n_cols, m))
    t.sort_indices()
    c, v, _ = ell_planes_from_scipy(t, dtype=val.dtype)
    return c, v


def dist_op_from_planes(col, val, *, ndev: int, mode: str, halo: int,
                        m_in: int, n_in_real: int,
                        transport: str = "ppermute") -> DistOp:
    """A host ``DistOp`` from global padded ELL planes ``(ndev·m_out, K)``
    whose columns are already in ``mode``'s convention (window-local for
    ``halo``, global otherwise): the blocks are the planes' row blocks; a
    ``replicated`` (transition) operator also gets its Pᵀ blocks."""
    m_out = col.shape[0] // ndev
    if m_out * ndev != col.shape[0]:
        raise ValueError(f"{col.shape[0]} rows do not split into {ndev} "
                         "shards")
    blocks = tuple((np.ascontiguousarray(col[i * m_out:(i + 1) * m_out]),
                    np.ascontiguousarray(val[i * m_out:(i + 1) * m_out]))
                   for i in range(ndev))
    tblocks = None
    n_in = ndev * m_in
    if mode == "replicated":
        tblocks = tuple(_transpose_block(c, v, n_in_real) for c, v in blocks)
        m_in = n_in = n_in_real
    return DistOp(blocks=blocks, mode=mode, halo=int(halo), m_in=int(m_in),
                  n_in=int(n_in), n_in_real=int(n_in_real),
                  transport=transport, tblocks=tblocks)


def make_dist_op(col, val, *, ndev: int, out_sharded: bool, in_sharded: bool,
                 m_in: int, n_in_real: int, transition: bool = False,
                 transport: str = "ppermute"):
    """The reference's ``_make_dist_op`` (its routed plans and overlap
    split left out): a ``DistOp``, or a ``HostEll`` when the rows are
    replicated."""
    n_out = col.shape[0]
    if not out_sharded:
        return HostEll(col=col, val=val, n_cols=int(n_in_real))
    m_out = math.ceil(n_out / ndev)
    colp = _pad_rows(col, ndev * m_out)
    valp = _pad_rows(val, ndev * m_out)
    kw = dict(ndev=ndev, m_in=m_in, n_in_real=n_in_real, transport=transport)
    if transition or not in_sharded:
        # rows sharded, input replicated: global columns
        return dist_op_from_planes(colp, valp, mode="replicated", halo=0,
                                   **kw)
    valid = valp != 0
    in_start = np.repeat(np.arange(ndev, dtype=np.int64) * m_in, m_out)
    rel = colp.astype(np.int64) - in_start[:, None]
    rel_valid = np.where(valid, rel, 0)
    h_left = max(0, int(-rel_valid.min(initial=0)))
    h_right = max(0, int(rel_valid.max(initial=0)) - (m_in - 1))
    h = max(h_left, h_right)
    if h > m_in:
        # a halo wider than a block: every shard reads the whole vector
        return dist_op_from_planes(colp, valp, mode="gather", halo=0, **kw)
    local = np.where(valid, rel + h, h).astype(np.int32)
    return dist_op_from_planes(local, valp, mode="halo", halo=h, **kw)


def host_ell(op) -> tuple:
    """Host ``(col, val, n_cols)`` ELL planes of a level operator of a port
    hierarchy (a ``Csr`` or ``TileCsr``, ``Dia`` or ``ConstDia``, or a grid
    transfer, materialised as the reference's ``_ell_np`` does)."""
    if isinstance(op, (GridProlong, GridRestrict)):
        p = op if isinstance(op, GridProlong) else GridProlong(
            fine_shape=op.fine_shape, coarse_shape=op.coarse_shape,
            coarsened=op.coarsened)
        m = prolong_to_scipy(p)
        if isinstance(op, GridRestrict):
            m = m.T.tocsr()
        return ell_planes_from_scipy(m, dtype=np.float32)
    if isinstance(op, ConstDia):
        op = const_to_dia(op)
    if isinstance(op, Dia):
        return ell_planes_from_dia(op, dtype=np.float32)
    import scipy.sparse as sp

    op = tile_to_csr(op)
    m = sp.csr_matrix((op.vals.float().cpu().numpy(),
                       op.indices.cpu().numpy(), op.indptr.cpu().numpy()),
                      shape=op.shape)
    return ell_planes_from_scipy(m, dtype=np.float32)


def partition_ell(levels, coarse_chol, params, ndev: int,
                  agg_rows_per_dev: int = 2048,
                  transport: str = "ppermute") -> DistHierarchy:
    """The general-sparsity partition (module docstring) of host levels:
    each a dict with the ELL planes ``a``, ``p`` and ``r`` (``(col, val,
    n_cols)`` triples), ``dinv`` (host) and ``lmax``; ``coarse_chol`` is
    the coarse-solve matrix (host or tensor)."""
    nlev = len(levels)
    sizes = [lv["a"][0].shape[0] for lv in levels] + [
        int(coarse_chol.shape[0])]
    sharded = []
    prev = True
    for l, n in enumerate(sizes):
        sh = prev and l < nlev and ndev > 1 \
            and math.ceil(n / ndev) >= agg_rows_per_dev
        sharded.append(bool(sh))
        prev = sh
    if ndev == 1:
        # one shard: every level is sharded, the dense coarse level not
        sharded = [l < nlev for l in range(nlev + 1)]
    m = [math.ceil(n / ndev) if sh else n for n, sh in zip(sizes, sharded)]

    out = []
    for l, lv in enumerate(levels):
        n_l, n_c = sizes[l], sizes[l + 1]
        a_col, a_val, _ = lv["a"]
        p_col, p_val, _ = lv["p"]
        r_col, r_val, _ = lv["r"]
        kw = dict(ndev=ndev, transport=transport)
        a_op = make_dist_op(a_col, a_val, out_sharded=sharded[l],
                            in_sharded=sharded[l], m_in=m[l], n_in_real=n_l,
                            **kw)
        transition = sharded[l] and not sharded[l + 1]
        p_op = make_dist_op(p_col, p_val, out_sharded=sharded[l],
                            in_sharded=sharded[l + 1], m_in=m[l + 1],
                            n_in_real=n_c, transition=transition, **kw)
        r_op = None
        if not transition:
            r_op = make_dist_op(r_col, r_val, out_sharded=sharded[l + 1],
                                in_sharded=sharded[l], m_in=m[l],
                                n_in_real=n_l, **kw)
        dinv = np.asarray(lv["dinv"], np.float32)
        if sharded[l]:
            dinv = _pad_rows(dinv, ndev * m[l], fill=np.float32(1.0))
        lmax = float(np.float32(lv["lmax"]))
        out.append(DistLevel(
            a=a_op, dinv=dinv, p=p_op, r=r_op, lmax=lmax,
            s=jacobi_scale(dinv, lmax, params), sharded=bool(sharded[l]),
            next_sharded=bool(sharded[l + 1]),
            n_next=int(ndev * m[l + 1] if sharded[l + 1] else n_c)))
    chol = coarse_chol if isinstance(coarse_chol, torch.Tensor) else \
        torch.from_numpy(np.asarray(coarse_chol, np.float32))
    return DistHierarchy(levels=tuple(out), coarse_chol=chol, params=params)


def partition_hierarchy(hier: Hierarchy, ndev: int,
                        agg_rows_per_dev: int = 2048,
                        transport: str = "ppermute") -> DistHierarchy:
    """The z-slab partition where level 0 shards by slabs, else the
    general-sparsity partition of the hierarchy's operators."""
    dh = _partition_structured(hier, ndev, agg_rows_per_dev, transport)
    if dh is not None:
        return dh
    levels = [dict(a=host_ell(lv.a), p=host_ell(lv.p), r=host_ell(lv.r),
                   dinv=lv.dinv, lmax=lv.lmax) for lv in hier.levels]
    return partition_ell(levels, hier.coarse_chol, hier.params, ndev,
                         agg_rows_per_dev, transport)


def with_transport(dh: DistHierarchy, transport: str) -> DistHierarchy:
    """The same hierarchy (the same tensors) with every sharded operator's
    halo exchange switched to ``transport``."""
    def switch(op):
        if isinstance(op, (SlabDia, DistOp)):
            return replace(op, transport=transport)
        return op

    return replace(dh, levels=tuple(
        replace(lv, a=switch(lv.a), p=switch(lv.p), r=switch(lv.r))
        for lv in dh.levels))


def _local(blocks, mesh) -> tuple:
    """The blocks of this process's shards."""
    return tuple(blocks[mesh.first:mesh.first + mesh.local])


def _split(t: torch.Tensor, mesh) -> tuple:
    """This process's row blocks of ``t`` (the last axis split into
    ``mesh.size`` blocks)."""
    if t.shape[-1] % mesh.size:
        raise ValueError(f"{t.shape[-1]} rows do not split into "
                         f"{mesh.size} shards")
    chunks = torch.chunk(t, mesh.size, dim=-1)
    return tuple(c.to(mesh.device).contiguous()
                 for c in _local(chunks, mesh))


def _value_dtype(vals) -> torch.dtype:
    """bf16 when that cast is lossless on every block, else f32 (the rule
    of ``dist_setup._compact``)."""
    if all(bf16_lossless(np.array(v, np.float32)) for v in vals):
        return torch.bfloat16
    return torch.float32


def _csr(col, val, n_cols: int, dtype, device) -> Csr:
    if n_cols >= 1 << 31:
        raise ValueError(f"{n_cols} columns overflow the CSR kernel's int32 "
                         "indices")
    c = csr_from_ell(col, np.asarray(val, np.float32), n_cols, "cpu")
    return Csr(indptr=c.indptr.to(device), indices=c.indices.to(device),
               vals=c.vals.to(dtype).to(device), n_cols=n_cols)


def _block_cols(op: DistOp) -> int:
    """The window length each block's columns address."""
    if op.mode == "halo":
        return op.m_in + 2 * op.halo
    if op.mode == "gather":
        return op.n_in
    return op.n_in_real


def _place_op(op, mesh):
    """A host ELL operator (``DistOp`` or ``HostEll``) as device ``Csr``:
    a ``DistOp``'s blocks of this process's shards, with the value type
    decided on every shard's block."""
    device = mesh.device
    if isinstance(op, HostEll):
        return _csr(op.col, op.val, op.n_cols, _value_dtype([op.val]),
                    device)
    if not isinstance(op, DistOp) or isinstance(op.blocks[0], Csr):
        return op
    dt = _value_dtype([v for _, v in op.blocks])
    n_cols = _block_cols(op)
    blocks = tuple(_csr(c, v, n_cols, dt, device)
                   for c, v in _local(op.blocks, mesh))
    tblocks = None
    if op.tblocks is not None:
        tdt = _value_dtype([v for _, v in op.tblocks])
        tblocks = tuple(_csr(c, v, _block_rows(b), tdt, device)
                        for (c, v), b in zip(_local(op.tblocks, mesh),
                                             blocks))
    return replace(op, blocks=blocks, tblocks=tblocks, mesh=mesh)


def _vector(v, mesh, sharded: bool):
    if isinstance(v, (float, list)):
        return v
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.array(v, np.float32))
    return list(_split(t, mesh)) if sharded else t.to(mesh.device)


def place_hierarchy(dh: DistHierarchy, mesh) -> DistHierarchy:
    """Put every level on the mesh's device: z-slab arrays (operator data,
    ``dinv``, ``s``) split into their ``mesh.size`` row blocks; ELL
    operators as per-shard (or, replicated, single) ``Csr`` blocks, their
    ``dinv`` and ``s`` split likewise (the z-slab family's replicated
    levels stay as built: on the device of the setup that made them). On a
    process mesh, this rank's blocks only; every sharded operator and the
    hierarchy carry the mesh."""
    def slab(op):
        if isinstance(op, (SlabProlong, SlabRestrict)):
            return replace(op, mesh=mesh)
        return op

    levels = []
    for lv in dh.levels:
        if isinstance(lv.a, SlabDia):
            lv = replace(lv, a=replace(lv.a, data=_split(lv.a.data, mesh),
                                       mesh=mesh),
                         p=slab(lv.p), r=slab(lv.r),
                         dinv=list(_split(lv.dinv, mesh)),
                         s=list(_split(lv.s, mesh)))
        elif isinstance(lv.a, (DistOp, HostEll)):
            lv = replace(lv, a=_place_op(lv.a, mesh),
                         p=_place_op(lv.p, mesh),
                         r=_place_op(lv.r, mesh),
                         dinv=_vector(lv.dinv, mesh, lv.sharded),
                         s=_vector(lv.s, mesh, lv.sharded))
        levels.append(lv)
    return replace(dh, levels=tuple(levels),
                   coarse_chol=dh.coarse_chol.to(mesh.device), mesh=mesh)


def pad_vector(x, dh: DistHierarchy, ndev: int):
    """``x`` (numpy or a tensor) as level 0's global rows: an ELL level 0
    pads its row blocks to ``ndev·m`` rows with zeros; z-slab levels split
    evenly and pad nothing. A longer vector, or a vector of another length
    on a z-slab level 0, raises."""
    a0 = dh.levels[0].a
    n0 = a0.n_rows
    pad = n0 - x.shape[0]
    if pad < 0 or (pad and not isinstance(a0, (DistOp, HostEll))):
        raise ValueError(f"vector of {x.shape[0]} rows for an operator of "
                         f"{n0}")
    if pad == 0:
        return x
    if isinstance(x, torch.Tensor):
        return torch.nn.functional.pad(x, (0, pad))
    return np.concatenate([x, np.zeros(pad, np.asarray(x).dtype)])


def unpad_vector(x, n_real: int):
    return x[:n_real]
