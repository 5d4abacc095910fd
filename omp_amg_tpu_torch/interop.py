"""Carry a hierarchy built elsewhere (for example by the JAX reference) into
the port, as numpy arrays.

``hierarchy_from_numpy`` takes per level the operator A, the transfers P and
R, ``dinv`` and ``lmax``; plus the coarse-solve matrix (the Cholesky factor,
or with ``coarse_solver="inv"`` the inverse) and the parameters. ``s`` and
the device ``dinv`` take the forms the port's setup gives them (one float
on a ``ConstDia`` level where they are constant). ELL padding (col 0,
val 0) is dropped on the way to CSR; each row keeps its slot order.
``dist_hierarchy_from_numpy`` does the same for a z-slab distributed
hierarchy, onto a ``ShardMesh``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .amg.hierarchy import Hierarchy, make_level
from .amg.params import AMGParams
from .amg.structured import GridProlong, GridRestrict
from .sparse.formats import ConstDia, Dia, csr_from_ell, dia_to_device
from .utils.device import resolve_device


def _params(params) -> AMGParams:
    if isinstance(params, AMGParams):
        return params
    return AMGParams(**dataclasses.asdict(params))   # a same-field dataclass


def _operator(lv, device):
    if "a_const" in lv:
        c = lv["a_const"]
        device = torch.empty(0, device=device).device
        return ConstDia(coeffs=tuple(float(v) for v in c["coeffs"]),
                        offsets=tuple(int(o) for o in c["offsets"]),
                        taps=tuple(tuple(int(d) for d in t)
                                   for t in c["taps"]),
                        dims=tuple(int(d) for d in c["dims"]), device=device)
    if "a_data" in lv:
        dims = lv.get("a_dims")
        return dia_to_device(Dia(data=np.asarray(lv["a_data"]),
                                 offsets=tuple(lv["a_offsets"]),
                                 dims=None if dims is None else tuple(dims)),
                             device)
    return csr_from_ell(lv["a_col"], lv["a_val"], lv["a_n_cols"], device)


def _transfers(lv, device):
    if "grid" in lv:
        fine, coarse, coarsened = lv["grid"]
        shape = dict(fine_shape=tuple(int(d) for d in fine),
                     coarse_shape=tuple(int(d) for d in coarse),
                     coarsened=tuple(bool(c) for c in coarsened))
        return GridProlong(**shape), GridRestrict(**shape)
    return (csr_from_ell(lv["p_col"], lv["p_val"], lv["p_n_cols"], device),
            csr_from_ell(lv["r_col"], lv["r_val"], lv["r_n_cols"], device))


def hierarchy_from_numpy(levels, coarse_chol, params,
                         device="cuda") -> Hierarchy:
    """Port ``Hierarchy`` from numpy arrays.

    ``levels`` is a sequence of dicts, one per level, with ``dinv`` and
    ``lmax`` and

    - A: ``a_const`` (a dict of ``coeffs``, ``taps``, ``offsets`` and
      ``dims``: a matrix-free stencil), or ``a_data`` and ``a_offsets``
      (optional ``a_dims``: banded A), or ``a_col``, ``a_val`` and
      ``a_n_cols`` (ELL A);
    - P and R: ``grid`` = ``(fine_shape, coarse_shape, coarsened)`` (the
      structured grid transfers), or the ELL planes ``p_col``, ``p_val``,
      ``p_n_cols``, ``r_col``, ``r_val``, ``r_n_cols``.

    ``coarse_chol`` is the coarse-solve matrix of ``params.coarse_solver``.
    ``params`` is an ``AMGParams`` or any dataclass with the same fields
    (such as the reference's).
    """
    params = _params(params)
    device = resolve_device(device)
    out = [make_level(_operator(lv, device), lv["dinv"], lv["lmax"],
                      *_transfers(lv, device), params, device)
           for lv in levels]
    chol = torch.tensor(np.asarray(coarse_chol, np.float32), device=device)
    return Hierarchy(levels=tuple(out), coarse_chol=chol, params=params)


def dist_hierarchy_from_numpy(levels, coarse_chol, params, mesh,
                              transport: str = "ppermute"):
    """Port ``DistHierarchy`` (the z-slab distribution) from numpy arrays,
    placed on ``mesh`` (a ``ShardMesh``).

    ``levels`` is a sequence of dicts, one per level, with ``sharded``,
    ``dinv`` (global rows), ``lmax`` and ``grid`` =
    ``(fine_shape, coarse_shape, coarsened)``, and

    - a sharded level: the global DIA planes ``a_data`` ``(ndiag, n)``,
      ``a_offsets``, ``a_dims``, the halo planes ``hl`` and ``hr``, and the
      transitions ``slice_in`` and ``gather_out`` (true where the next level
      is replicated);
    - a replicated level: ``a_data``, ``a_offsets`` and optional ``a_dims``
      (a banded A).

    Sharded levels split into ``mesh.size`` row blocks (values in bf16 when
    that cast is lossless, else f32) and run ``transport``; replicated
    levels take the single-device forms of ``hierarchy_from_numpy``.
    ``params`` is an ``AMGParams`` or any dataclass with the same fields.
    """
    from .amg.hierarchy import jacobi_scale
    from .parallel.dist import DistHierarchy, DistLevel
    from .parallel.dist_setup import _compact
    from .parallel.partition import _split
    from .parallel.slab import SlabDia, SlabProlong, SlabRestrict

    params = _params(params)
    dev = mesh.device
    out = []
    for lv in levels:
        fine, coarse, coarsened = lv["grid"]
        shape = dict(fine_shape=tuple(int(d) for d in fine),
                     coarse_shape=tuple(int(d) for d in coarse),
                     coarsened=tuple(bool(c) for c in coarsened))
        lmax = float(np.float32(lv["lmax"]))
        if lv["sharded"]:
            dinv = np.asarray(lv["dinv"], np.float32)
            s = torch.from_numpy(jacobi_scale(dinv, lmax, params))
            dinv = torch.from_numpy(dinv.copy())
            data = torch.from_numpy(np.array(lv["a_data"], np.float32))
            a = SlabDia(data=_compact(_split(data, mesh)),
                        offsets=tuple(int(o) for o in lv["a_offsets"]),
                        dims=tuple(int(d) for d in lv["a_dims"]),
                        hl=int(lv["hl"]), hr=int(lv["hr"]),
                        transport=transport)
            out.append(DistLevel(
                a=a, dinv=list(_split(dinv, mesh)),
                p=SlabProlong(**shape, slice_in=bool(lv["slice_in"])),
                r=SlabRestrict(**shape, gather_out=bool(lv["gather_out"])),
                lmax=lmax, s=list(_split(s, mesh)), sharded=True))
        else:
            rep = make_level(_operator(lv, dev), lv["dinv"], lmax,
                             GridProlong(**shape), GridRestrict(**shape),
                             params, dev)
            out.append(DistLevel(a=rep.a, dinv=rep.dinv_dev, p=rep.p,
                                 r=rep.r, lmax=rep.lmax, s=rep.s,
                                 sharded=False))
    chol = torch.tensor(np.asarray(coarse_chol, np.float32), device=dev)
    return DistHierarchy(levels=tuple(out), coarse_chol=chol, params=params)
