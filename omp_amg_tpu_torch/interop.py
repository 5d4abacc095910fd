"""Carry a hierarchy built elsewhere (for example by the JAX reference) into
the port, as numpy arrays.

``hierarchy_from_numpy`` takes per level the fine ``Dia`` data and offsets
(level 0) or the padded ELL ``col``/``val``/``n_cols`` of A (coarser
levels), the ELL planes of P and R, ``dinv`` and ``lmax``; plus the coarse
Cholesky factor and the parameters. ELL padding (col 0, val 0) is dropped on
the way to CSR; each row keeps its slot order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .amg.hierarchy import Hierarchy, make_level
from .amg.params import AMGParams
from .sparse.formats import Dia, csr_from_ell, dia_to_device


def _params(params) -> AMGParams:
    if isinstance(params, AMGParams):
        return params
    return AMGParams(**dataclasses.asdict(params))   # a same-field dataclass


def hierarchy_from_numpy(levels, coarse_chol, params,
                         device="cpu") -> Hierarchy:
    """Port ``Hierarchy`` from numpy arrays.

    ``levels`` is a sequence of dicts with keys ``a_data`` and
    ``a_offsets`` (banded A) or ``a_col``, ``a_val`` and ``a_n_cols`` (ELL
    A); ``p_col``, ``p_val``, ``p_n_cols``; ``r_col``, ``r_val``,
    ``r_n_cols``; ``dinv``; ``lmax``. ``params`` is an ``AMGParams`` or any
    dataclass with the same fields (such as the reference's).
    """
    params = _params(params)
    device = torch.device(device)
    out = []
    for lv in levels:
        if "a_data" in lv:
            a = dia_to_device(Dia(data=np.asarray(lv["a_data"]),
                                  offsets=tuple(lv["a_offsets"])), device)
        else:
            a = csr_from_ell(lv["a_col"], lv["a_val"], lv["a_n_cols"],
                             device)
        out.append(make_level(
            a, lv["dinv"], lv["lmax"],
            csr_from_ell(lv["p_col"], lv["p_val"], lv["p_n_cols"], device),
            csr_from_ell(lv["r_col"], lv["r_val"], lv["r_n_cols"], device),
            params, device))
    chol = torch.tensor(np.asarray(coarse_chol, np.float32), device=device)
    return Hierarchy(levels=tuple(out), coarse_chol=chol, params=params)
