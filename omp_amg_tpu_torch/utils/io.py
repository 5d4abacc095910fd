"""Matrix I/O and hierarchy checkpoints (counterpart of
``omp_amg_tpu/utils/io.py``).

- MatrixMarket read and write through scipy.
- A hierarchy saved as one ``.npz`` with a JSON ``__meta__`` entry, so
  that a setup can be reused across runs and processes. Every level form
  the port builds round-trips bit for bit: ``Csr`` and ``Dia`` with f32 or
  bf16 values (bf16 stored as its 16-bit pattern), ``TileCsr`` (written as
  its global CSR; ``make_level``'s rule gives the tiled form again on
  load), ``ConstDia`` (taps and
  coefficients only: the port keeps no mask arrays, validity is index
  arithmetic, ``const_masks``), ``GridProlong`` and ``GridRestrict``; with
  ``dinv``, ``lmax``, ``coarse_chol`` and the ``AMGParams``. The Jacobi
  scale ``s`` and the device ``dinv_dev`` are rebuilt by ``make_level``
  from ``dinv``, ``lmax`` and the parameters, as the setup built them.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..amg.hierarchy import Hierarchy, make_level
from ..amg.params import AMGParams
from ..amg.structured import GridProlong, GridRestrict
from ..sparse.formats import (  # noqa: F401  (csr_to_scipy: re-exported)
    ConstDia, Csr, Dia, TileCsr, const_to_dia, csr_from_scipy,
    csr_to_scipy, tile_to_csr,
)
from .device import resolve_device


def read_matrix_market(path, device="cuda"):
    """Read a MatrixMarket file: (f32 ``Csr`` on ``device``, scipy CSR f64
    with sorted indices)."""
    import scipy.io
    import scipy.sparse as sp

    a = sp.csr_matrix(scipy.io.mmread(path), dtype=np.float64)
    a.sort_indices()
    return csr_from_scipy(a, torch.float32, device=resolve_device(device)), a


def write_matrix_market(path, a, comment: str = "") -> None:
    """Write a ``Dia``, ``ConstDia``, ``Csr``, ``TileCsr`` or scipy matrix
    as a MatrixMarket file."""
    import scipy.io
    import scipy.sparse as sp

    from ..sparse.formats import dia_to_scipy

    if isinstance(a, ConstDia):
        a = const_to_dia(a)
    if isinstance(a, Dia):
        m = dia_to_scipy(a)
    elif isinstance(a, (Csr, TileCsr)):
        m = csr_to_scipy(a)
    else:
        m = sp.csr_matrix(a)
    scipy.io.mmwrite(path, m, comment=comment)


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A tensor as a host array and its dtype's name; bf16 as the uint16
    view of its bits (numpy has no bfloat16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _put(prefix, name, t, out, meta):
    out[f"{prefix}:{name}"], meta[f"{prefix}:{name}:dtype"] = _to_numpy(t)


def _get(prefix, name, data, meta, device):
    return _from_numpy(data[f"{prefix}:{name}"],
                       meta[f"{prefix}:{name}:dtype"], device)


def _pack_op(prefix: str, op, out: dict, meta: dict) -> None:
    if isinstance(op, (GridProlong, GridRestrict)):
        meta[prefix + ":kind"] = ("gridp" if isinstance(op, GridProlong)
                                  else "gridr")
        meta[prefix + ":fine"] = [int(d) for d in op.fine_shape]
        meta[prefix + ":coarse"] = [int(d) for d in op.coarse_shape]
        meta[prefix + ":axes"] = [bool(c) for c in op.coarsened]
    elif isinstance(op, ConstDia):
        meta[prefix + ":kind"] = "cdia"
        meta[prefix + ":offsets"] = [int(o) for o in op.offsets]
        meta[prefix + ":dims"] = [int(d) for d in op.dims]
        meta[prefix + ":taps"] = [[int(v) for v in t] for t in op.taps]
        meta[prefix + ":coeffs"] = [float(c) for c in op.coeffs]
    elif isinstance(op, Dia):
        meta[prefix + ":kind"] = "dia"
        meta[prefix + ":offsets"] = [int(o) for o in op.offsets]
        meta[prefix + ":dims"] = ([int(d) for d in op.dims] if op.dims
                                  else None)
        data = op.data if isinstance(op.data, torch.Tensor) else \
            torch.from_numpy(np.asarray(op.data))
        _put(prefix, "data", data, out, meta)
    elif isinstance(op, (Csr, TileCsr)):    # the tiled form as its global CSR
        op = tile_to_csr(op)
        meta[prefix + ":kind"] = "csr"
        meta[prefix + ":n_cols"] = int(op.n_cols)
        for name in ("indptr", "indices", "vals"):
            _put(prefix, name, getattr(op, name), out, meta)
    else:
        raise TypeError(f"cannot save a {type(op).__name__} operator")


def _unpack_op(prefix: str, data: dict, meta: dict, device):
    kind = meta[prefix + ":kind"]
    if kind in ("gridp", "gridr"):
        cls = GridProlong if kind == "gridp" else GridRestrict
        return cls(fine_shape=tuple(meta[prefix + ":fine"]),
                   coarse_shape=tuple(meta[prefix + ":coarse"]),
                   coarsened=tuple(meta[prefix + ":axes"]))
    if kind == "cdia":
        return ConstDia(coeffs=tuple(meta[prefix + ":coeffs"]),
                        offsets=tuple(meta[prefix + ":offsets"]),
                        taps=tuple(tuple(t) for t in meta[prefix + ":taps"]),
                        dims=tuple(meta[prefix + ":dims"]),
                        device=torch.empty(0, device=device).device)
    if kind == "dia":
        dims = meta[prefix + ":dims"]
        return Dia(data=_get(prefix, "data", data, meta, device),
                   offsets=tuple(meta[prefix + ":offsets"]),
                   dims=tuple(dims) if dims else None)
    if kind == "csr":
        return Csr(indptr=_get(prefix, "indptr", data, meta, device),
                   indices=_get(prefix, "indices", data, meta, device),
                   vals=_get(prefix, "vals", data, meta, device),
                   n_cols=int(meta[prefix + ":n_cols"]))
    raise ValueError(f"unknown operator kind {kind!r} in the checkpoint")


def save_hierarchy(path, hier: Hierarchy) -> None:
    """Write ``hier`` (a serial hierarchy on any device) to one ``.npz``
    (numpy appends the suffix when ``path`` lacks it)."""
    arrays: dict = {}
    meta: dict = {"n_levels": len(hier.levels),
                  "params": dataclasses.asdict(hier.params)}
    for i, lv in enumerate(hier.levels):
        _pack_op(f"l{i}:a", lv.a, arrays, meta)
        _pack_op(f"l{i}:p", lv.p, arrays, meta)
        _pack_op(f"l{i}:r", lv.r, arrays, meta)
        dinv = lv.dinv
        if isinstance(dinv, torch.Tensor):      # a device setup's dinv
            dinv = dinv.cpu().numpy()
        arrays[f"l{i}:dinv"] = np.asarray(dinv, np.float32)
        arrays[f"l{i}:lmax"] = np.asarray(lv.lmax, np.float64)
    arrays["coarse_chol"] = hier.coarse_chol.detach().cpu().numpy()
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_hierarchy(path, device="cuda") -> Hierarchy:
    """Read a hierarchy written by :func:`save_hierarchy` onto ``device``
    (without CUDA, ``"cuda"`` raises RuntimeError)."""
    device = resolve_device(device)
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    meta = json.loads(bytes(data.pop("__meta__")).decode())
    params = AMGParams(**meta["params"])
    levels = []
    for i in range(meta["n_levels"]):
        levels.append(make_level(
            _unpack_op(f"l{i}:a", data, meta, device),
            data[f"l{i}:dinv"], float(data[f"l{i}:lmax"]),
            _unpack_op(f"l{i}:p", data, meta, device),
            _unpack_op(f"l{i}:r", data, meta, device), params, device))
    return Hierarchy(levels=tuple(levels),
                     coarse_chol=torch.from_numpy(data["coarse_chol"]).to(
                         device),
                     params=params)
