"""Distributed (per-shard) structured AMG setup (counterpart of
``omp_amg_tpu/parallel/dist_setup.py``).

No sharded level operator is ever assembled whole: each level lives as
z-plane slabs (:class:`.slab.SlabDia`) and the Galerkin product
A_c = R A P is computed shard by shard by lattice-comb probing, rebuilt
from the slab primitives:

- the 3^d probe chains ``R (A (P v_t))`` run on the shards with plain plane
  exchanges, in float32 as the reference's device chain does;
- probe vectors and assembly selectors come from *global* coordinates, so
  every per-level array is bit-identical across shard counts (the
  determinism contract of the reference);
- λmax per level is a distributed float32 power iteration (shard-order
  dots) from the same hash seed as the single-device setups;
- structure decisions (strong axes, level sizes, termination) stay on the
  host.

Coarse levels below the slab-alignment and size thresholds are
agglomerated: their small operator is pulled to the host once and the
remaining levels come from the port's host structured setup, replicated.
"""

from __future__ import annotations

import dataclasses
from itertools import product as iproduct

import numpy as np
import torch

from ..amg.comb_rap import coarse_offsets
from ..amg.hierarchy import amg_setup, check_supported, jacobi_omega
from ..amg.host_setup import hash01_np
from ..amg.params import AMGParams
from ..amg.structured import strong_axes_from_values
from ..sparse.formats import Dia
from .dist import DistHierarchy, DistLevel, pdot, pnorm
from .mesh import pmax, psum
from .slab import (
    SlabDia, SlabProlong, SlabRestrict, check_transport, slab_halos,
    slab_prolong, slab_restrict, slab_spmv,
)


def _prod(t) -> int:
    return int(np.prod(t, dtype=np.int64)) if len(t) else 1


def _global_coords(coarse_dims, nc_local: int, shard: int, device):
    """Per-axis GLOBAL coordinates of shard ``shard``'s coarse slab rows."""
    cplane = _prod(coarse_dims[1:])
    nzc_l = nc_local // cplane
    idx = torch.arange(nc_local, dtype=torch.int64, device=device)
    coords = [idx // cplane + shard * nzc_l]
    for ax in range(1, len(coarse_dims)):
        stride = _prod(coarse_dims[ax + 1:])
        coords.append((idx // stride) % coarse_dims[ax])
    return coords


def _hash_probe(n_loc: int, d: int, device) -> list:
    """hash01(global row) − 0.5 per shard, f32 (the deterministic probe and
    power-iteration start of every setup flavour)."""
    return [torch.from_numpy(hash01_np(np.arange(i * n_loc, (i + 1) * n_loc))
                             - np.float32(0.5)).to(device) for i in range(d)]


def _comb_rap_local(op: SlabDia, *, coarse_dims, axes):
    """Per-shard coarse DIA planes of R A P, and the radius-contract check.

    Mirrors the reference's shard-local comb RAP: the period-3 lattice combs
    separate every coarse row's couplings; probes and selectors use global
    coordinates. Returns (per-shard data, err, scale): err is the largest
    |A_c x − R A P x| of one hash probe over the shards, scale its
    max|R A P x|.
    """
    dims = op.dims
    nd = len(dims)
    d = len(op.blocks)
    dev = op.data[0].device
    cplane = _prod(coarse_dims[1:])
    nc_l = coarse_dims[0] // d * cplane
    sp = SlabProlong(fine_shape=dims, coarse_shape=coarse_dims,
                     coarsened=axes)
    sr = SlabRestrict(fine_shape=dims, coarse_shape=coarse_dims,
                      coarsened=axes)

    def chain(vs):
        return slab_restrict(sr, slab_spmv(op, slab_prolong(sp, vs, d)))

    coords = [_global_coords(coarse_dims, nc_l, i, dev) for i in range(d)]
    tlist = list(iproduct(range(3), repeat=nd))
    ws = [[] for _ in range(d)]        # per shard: 3^nd responses
    for tvec in tlist:
        vs = []
        for c in coords:
            m = torch.ones(nc_l, dtype=torch.bool, device=dev)
            for ax in range(nd):
                m &= c[ax] % 3 == tvec[ax]
            vs.append(m.float())
        for i, w in enumerate(chain(vs)):
            ws[i].append(w)
    ws = [torch.stack(w) for w in ws]  # (3^nd, nc_l) per shard

    strides = [_prod(coarse_dims[ax + 1:]) for ax in range(nd)]
    sel, offs = [], []
    for delta in iproduct((-1, 0, 1), repeat=nd):
        if any(abs(dl) >= cd for dl, cd in zip(delta, coarse_dims)):
            continue
        sel.append(delta)
        offs.append(sum(dl * st for dl, st in zip(delta, strides)))
    # small coarse grids alias distinct deltas onto interleaved/duplicate
    # flat offsets: pair rows to coarse_offsets() order with a STABLE sort
    order = np.argsort(offs, kind="stable")
    data_c = []
    for i in range(d):
        rows = []
        for k in order:
            tsel = torch.zeros(nc_l, dtype=torch.int64, device=dev)
            for ax in range(nd):
                tsel = tsel * 3 + (coords[i][ax] + sel[k][ax]) % 3
            # the comb that holds the coupling: exactly the reference's
            # one-hot sum over the 3^nd responses
            rows.append(ws[i].gather(0, tsel[None])[0])
        data_c.append(torch.stack(rows))

    # radius-contract validation: one deterministic random probe
    offs_c = coarse_offsets(coarse_dims)
    chl, chr_ = slab_halos(offs_c, coarse_dims)
    cop = SlabDia(data=tuple(data_c), offsets=tuple(offs_c),
                  dims=tuple(coarse_dims), hl=chl, hr=chr_)
    x = _hash_probe(nc_l, d, dev)
    y1 = slab_spmv(cop, x)
    y2 = chain(x)
    err = float(pmax([(u - v).abs().max() for u, v in zip(y1, y2)]))
    scale = float(pmax([v.abs().max() for v in y2]))
    return data_c, err, scale


def _lmax_local(op: SlabDia, dinv, *, iters: int = 20) -> float:
    """Distributed float32 power iteration for λmax(D⁻¹A), from the hash01
    start vector (the seed of ``_estimate_lmax_apply``)."""
    v = _hash_probe(dinv[0].numel(), len(dinv), dinv[0].device)

    def scaled(v):
        return [di * y for di, y in zip(dinv, slab_spmv(op, v))]

    nv = pnorm(v)
    v = [t / nv for t in v]
    for _ in range(iters):
        w = scaled(v)
        nw = pnorm(w)
        v = [t / nw for t in w]
    w = scaled(v)
    return float(np.float32((pdot(v, w) / pdot(v, v)).item()))


def _compact(parts) -> tuple:
    """Per-shard operator blocks, in bf16 when that cast is lossless on
    every shard (exact for the Poisson stencils and their Galerkin levels),
    else f32: the same rule as the single-device ``dia_to_device``."""
    if all(torch.equal(t.to(torch.bfloat16).float(), t) for t in parts):
        return tuple(t.to(torch.bfloat16) for t in parts)
    return tuple(parts)


def dist_structured_setup(a: Dia, grid, mesh, params: AMGParams = AMGParams(),
                          agg_rows_per_dev: int = 2048,
                          transport: str = "ppermute") -> DistHierarchy:
    """Build a sharded structured hierarchy on ``mesh`` without assembling
    any sharded level whole.

    ``a`` is the fine DIA operator (host numpy or torch data; its values are
    taken in float32, as the reference's are). Levels shard while the
    leading grid axis splits evenly across the mesh and the per-shard block
    stays at or above ``agg_rows_per_dev``; the rest are agglomerated
    through the host structured setup and replicated. Raises ValueError
    when no level can shard (the facade then partitions a central build).
    """
    if params.coarsening == "pmis":
        raise ValueError(
            "dist_structured_setup is the structured-coarsening path; "
            "the PMIS distribution is not ported")
    check_supported(params)
    check_transport(transport)
    d = mesh.size
    dev = mesh.device
    dims = tuple(int(g) for g in grid)
    if _prod(dims) != a.n_rows:
        raise ValueError("grid does not match operator size")
    offsets = list(a.offsets)
    data0 = a.data
    if not isinstance(data0, torch.Tensor):
        data0 = torch.from_numpy(np.ascontiguousarray(data0, np.float32))
    data = None
    if dims[0] % d == 0:
        data = tuple(c.contiguous() for c in torch.chunk(
            data0.to(dev, torch.float32), d, dim=1))

    sh_levels = []
    n = _prod(dims)
    while n > params.coarse_size and len(sh_levels) < params.max_levels - 1:
        if dims[0] % d != 0 or n // d < agg_rows_per_dev:
            break
        sums = psum([t.double().sum(dim=1) for t in data])
        counts = psum([(t != 0).sum(dim=1) for t in data])
        means = (sums / counts.clamp(min=1)).cpu().numpy()
        axes = strong_axes_from_values(offsets, means, dims, params.theta)
        if not any(axes):
            break
        if axes[0] and dims[0] % (2 * d) != 0:
            break
        coarse_dims = tuple((dd + 1) // 2 if c else dd
                            for dd, c in zip(dims, axes))
        hl, hr = slab_halos(offsets, dims)
        op = SlabDia(data=data, offsets=tuple(offsets), dims=dims, hl=hl,
                     hr=hr)
        data_c, err, scale = _comb_rap_local(op, coarse_dims=coarse_dims,
                                             axes=axes)
        if err > 2e-4 * (scale + 1e-30):
            raise ValueError(
                f"distributed comb RAP radius contract violated: {err}")
        offs_c = coarse_offsets(coarse_dims)
        maxes = pmax([t.abs().amax(dim=1) for t in data_c]).cpu().numpy()
        keep = [k for k in range(len(offs_c)) if maxes[k] > 0]
        keep_t = torch.tensor(keep, dtype=torch.int64, device=dev)
        data_c = tuple(t.index_select(0, keep_t).contiguous()
                       for t in data_c)
        if params.smoother == "l1jacobi":
            # the row l1 norm: out-of-range taps are stored as exact zeros
            dinv = [1.0 / t.abs().sum(dim=0) for t in data]
        else:
            dinv = [1.0 / t[offsets.index(0)] for t in data]
        lmax = _lmax_local(op, dinv)
        sh_levels.append((list(offsets), dims, data, dinv, lmax, axes,
                          coarse_dims, hl, hr))
        offsets, data, dims = [offs_c[k] for k in keep], data_c, coarse_dims
        n = _prod(dims)

    nsh = len(sh_levels)
    if nsh == 0:
        raise ValueError(
            "no level met the slab sharding constraints: use the "
            "single-device setup (amg_setup) for this problem and mesh")
    # agglomerated tail: pull the (small) remaining operator once, finish
    # with the host structured setup, replicate those levels
    a_tail = Dia(data=torch.cat(data, dim=1).cpu().numpy(),
                 offsets=tuple(offsets), dims=dims)
    # the tail shares the user's level budget with the sharded prefix
    tail_params = dataclasses.replace(
        params, max_levels=max(2, params.max_levels - nsh))
    tail = amg_setup(a_tail, tail_params, device=dev, grid=dims)

    levels = []
    for l, (offs, dms, dat, dinv, lmax, axes, cdims, hl, hr) \
            in enumerate(sh_levels):
        trans = l + 1 == nsh
        omega = float(jacobi_omega(lmax, params))
        shape = dict(fine_shape=dms, coarse_shape=cdims, coarsened=axes)
        levels.append(DistLevel(
            a=SlabDia(data=_compact(dat), offsets=tuple(offs), dims=dms,
                      hl=hl, hr=hr, transport=transport),
            dinv=dinv, p=SlabProlong(**shape, slice_in=trans),
            r=SlabRestrict(**shape, gather_out=trans), lmax=lmax,
            s=[t * omega for t in dinv], sharded=True))
    for lv in tail.levels:
        levels.append(DistLevel(
            a=lv.a, dinv=lv.dinv_dev, p=lv.p, r=lv.r, lmax=lv.lmax, s=lv.s,
            sharded=False))
    return DistHierarchy(levels=tuple(levels), coarse_chol=tail.coarse_chol,
                         params=params)
