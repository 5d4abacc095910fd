"""Carry a hierarchy built elsewhere (for example by the JAX reference) into
the port, as numpy arrays.

``hierarchy_from_numpy`` takes per level the operator A, the transfers P and
R, ``dinv`` and ``lmax``; plus the coarse Cholesky factor and the
parameters. ELL padding (col 0, val 0) is dropped on the way to CSR; each
row keeps its slot order.
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
