"""Host-side partition of a centrally built structured hierarchy
(counterpart of the structured branch of
``omp_amg_tpu/parallel/partition.py``).

Levels shard by z-plane slabs while their leading grid axis splits evenly
over the mesh (and evenly into coarse pairs when that axis is coarsened)
and the per-shard block stays at or above ``agg_rows_per_dev``; the coarser
levels are replicated (agglomeration). ``partition_hierarchy`` decides the
layout and keeps each sharded array whole; ``place_hierarchy`` splits each
into its ``d`` blocks on the mesh's device. The general-sparsity (ELL)
partition of the PMIS family is not ported.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..amg.hierarchy import Hierarchy
from ..amg.structured import GridProlong
from ..sparse.formats import ConstDia, Dia, const_to_dia
from .dist import DistHierarchy, DistLevel
from .slab import SlabDia, SlabProlong, SlabRestrict, slab_halos


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


def partition_hierarchy(hier: Hierarchy, ndev: int,
                        agg_rows_per_dev: int = 2048,
                        transport: str = "ppermute") -> DistHierarchy:
    dh = _partition_structured(hier, ndev, agg_rows_per_dev, transport)
    if dh is None:
        raise NotImplementedError(
            "level 0 does not shard by z-slabs; the general-sparsity (ELL) "
            "partition is not ported yet")
    return dh


def _split(t: torch.Tensor, mesh) -> tuple:
    if t.shape[-1] % mesh.size:
        raise ValueError(f"{t.shape[-1]} rows do not split into "
                         f"{mesh.size} shards")
    return tuple(c.contiguous()
                 for c in torch.chunk(t.to(mesh.device), mesh.size, dim=-1))


def place_hierarchy(dh: DistHierarchy, mesh) -> DistHierarchy:
    """Split every sharded array (operator data, ``dinv``, ``s``) into its
    ``mesh.size`` row blocks on the mesh's device (the replicated levels
    stay as built: on the device of the setup that made them)."""
    levels = []
    for lv in dh.levels:
        if lv.sharded:
            lv = replace(lv, a=replace(lv.a, data=_split(lv.a.data, mesh)),
                         dinv=list(_split(lv.dinv, mesh)),
                         s=list(_split(lv.s, mesh)))
        levels.append(lv)
    return replace(dh, levels=tuple(levels),
                   coarse_chol=dh.coarse_chol.to(mesh.device))


def pad_vector(x, dh: DistHierarchy, ndev: int):
    """``x`` as level 0's global rows. Z-slab levels split evenly, so the
    structured distribution pads nothing (the reference pads the row blocks
    of its ELL partition); a vector of another length raises."""
    if x.shape[0] != dh.levels[0].a.n_rows:
        raise ValueError(f"vector of {x.shape[0]} rows for an operator of "
                         f"{dh.levels[0].a.n_rows}")
    return x


def unpad_vector(x, n_real: int):
    return x[:n_real]
