"""Structured (tensor-grid) coarsening: grid transfers and axis selection.

Counterpart of ``omp_amg_tpu/amg/structured.py``. For stencil operators on
regular grids the hierarchy stays banded at every level: each strong axis is
coarsened by 2 (semicoarsening), with tensor-product linear interpolation
and exact Galerkin RAP (:mod:`.comb_rap`).

The transfers are the reference's slice forms on torch tensors, on every
device and for any number of axes: constant weights (1 and ½, exact in
f32), no gathers, bitwise the reference's CPU path. The reference computes
them outside any Pallas kernel (on the TPU as per-axis MXU matmuls, a
workaround for slow stride-2 slices there), so plain torch ops carry them
here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class GridProlong:
    """Tensor-product linear interpolation (coarse → fine)."""
    fine_shape: Tuple[int, ...]
    coarse_shape: Tuple[int, ...]
    coarsened: Tuple[bool, ...]

    @property
    def shape(self):
        return (int(np.prod(self.fine_shape)), int(np.prod(self.coarse_shape)))

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]


@dataclass(frozen=True)
class GridRestrict:
    """Transpose of ``GridProlong`` (fine → coarse)."""
    fine_shape: Tuple[int, ...]
    coarse_shape: Tuple[int, ...]
    coarsened: Tuple[bool, ...]

    @property
    def shape(self):
        return (int(np.prod(self.coarse_shape)), int(np.prod(self.fine_shape)))

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]


def _prolong_axis(x: torch.Tensor, axis: int, n_f: int) -> torch.Tensor:
    """Linear interpolation along one axis: (..., nc, ...) → (..., n_f, ...).

    even i → x_c[i/2]; odd i → (x_c[(i-1)/2] + x_c[(i+1)/2]) / 2 (Dirichlet:
    a missing right neighbour contributes 0)."""
    nc = x.shape[axis]
    xm = torch.movedim(x, axis, -1)
    right = torch.cat([xm[..., 1:], torch.zeros_like(xm[..., :1])], dim=-1)
    odd = 0.5 * (xm + right)
    inter = torch.stack([xm, odd], dim=-1).reshape(*xm.shape[:-1], 2 * nc)
    return torch.movedim(inter[..., :n_f], -1, axis)


def _restrict_axis(x: torch.Tensor, axis: int, nc: int) -> torch.Tensor:
    """Transpose of ``_prolong_axis``: y_c[j] = x[2j] + (x[2j-1]+x[2j+1])/2."""
    xm = torch.movedim(x, axis, -1)
    pad = torch.zeros_like(xm[..., :1])
    xp = torch.cat([pad, xm, pad, pad], dim=-1)  # fine i lives at xp[i+1]
    ext = 2 * nc
    even = xp[..., 1:1 + ext:2][..., :nc]
    lft = xp[..., 0:ext:2][..., :nc]
    rgt = xp[..., 2:2 + ext:2][..., :nc]
    return torch.movedim(even + 0.5 * (lft + rgt), -1, axis)


def apply_prolong(p: GridProlong, xc: torch.Tensor) -> torch.Tensor:
    """x = P·xc, a fresh contiguous tensor."""
    x = xc.reshape(p.coarse_shape)
    for ax, c in enumerate(p.coarsened):
        if c:
            x = _prolong_axis(x, ax, p.fine_shape[ax])
    return x.reshape(-1).contiguous()


def apply_restrict(r: GridRestrict, xf: torch.Tensor) -> torch.Tensor:
    """xc = R·xf (R = Pᵀ), a fresh contiguous tensor."""
    x = xf.reshape(r.fine_shape)
    for ax, c in enumerate(r.coarsened):
        if c:
            x = _restrict_axis(x, ax, r.coarse_shape[ax])
    return x.reshape(-1).contiguous()


# ---------------------------------------------------------------------------
# Host-side setup helpers (numpy)
# ---------------------------------------------------------------------------

def prolong_to_scipy(p: GridProlong):
    """P as scipy CSR (the setup's exact sparse Galerkin fallback, tests)."""
    import scipy.sparse as sp

    mats = []
    for ax, c in enumerate(p.coarsened):
        n_f, nc = p.fine_shape[ax], p.coarse_shape[ax]
        if not c:
            mats.append(sp.identity(n_f, format="csr"))
            continue
        rows, cols, vals = [], [], []
        for i in range(n_f):
            if i % 2 == 0:
                rows.append(i)
                cols.append(i // 2)
                vals.append(1.0)
            else:
                rows.append(i)
                cols.append((i - 1) // 2)
                vals.append(0.5)
                if (i + 1) // 2 < nc:
                    rows.append(i)
                    cols.append((i + 1) // 2)
                    vals.append(0.5)
        mats.append(sp.csr_matrix((vals, (rows, cols)), shape=(n_f, nc)))
    out = mats[0]
    for m in mats[1:]:
        out = sp.kron(out, m, format="csr")
    return out


def grid_strides(dims) -> list:
    """C-order strides of a grid: unknown i = Σ idx[ax]·strides[ax]."""
    strides = [1] * len(dims)
    for k in range(len(dims) - 2, -1, -1):
        strides[k] = strides[k + 1] * dims[k + 1]
    return strides


def axis_deltas(offsets: Sequence[int], dims: Tuple[int, ...]) -> np.ndarray:
    """Balanced per-axis decomposition of scalar DIA offsets (valid under
    the masked-zero invariant: stored taps never wrap a grid row)."""
    d = len(dims)
    strides = grid_strides(dims)
    out = np.zeros((len(offsets), d), np.int64)
    for ki, off in enumerate(offsets):
        rem = int(off)
        for ax in range(d):
            q = int(round(rem / strides[ax]))
            out[ki, ax] = q
            rem -= q * strides[ax]
    return out


def strong_axes_from_values(offsets, values, dims: Tuple[int, ...],
                            theta: float) -> Tuple[bool, ...]:
    """Axis selection from one representative value per diagonal: axis ax
    is coarsened iff c_ax ≥ θ·max c and its extent is > 2, with
    c_ax = max(0, Σ_taps −a_tap·δ_ax²)."""
    values = np.asarray(values, np.float64)
    deltas = axis_deltas(offsets, dims)
    c = np.zeros(len(dims))
    for ax in range(len(dims)):
        c[ax] = max(0.0, float(np.sum(-values * (deltas[:, ax] ** 2))))
    cmax = c.max()
    if cmax <= 0:
        return tuple(False for _ in dims)
    return tuple(bool(c[ax] >= theta * cmax and dims[ax] > 2)
                 for ax in range(len(dims)))


def strong_axes(planes, dims: Tuple[int, ...],
                theta: float) -> Tuple[bool, ...]:
    """Directional-stiffness axis selection on host ``(offsets, data)``
    planes, from the median tap values over fully interior rows.

    The signed sum c_ax = Σ −a_tap·δ_ax² measures the operator's stiffness
    along each axis: the ε-weak direction of an anisotropic operator scores
    about 0, while Galerkin operators whose strength drifted into edge and
    corner taps still score strong on every axis.
    """
    offsets, data = list(planes[0]), np.asarray(planes[1])
    n = data.shape[1]
    # a strided sample: translation-invariant interiors have identical
    # values per plane, so the sample's median equals the full median
    stride = max(1, n // 65536)
    if stride > 1 and dims:
        # keep the stride coprime with the grid dims so the sample walks all
        # plane/column positions instead of aliasing one of them
        while any(math.gcd(stride, max(d, 1)) != 1 for d in dims):
            stride += 1
    sub = np.ascontiguousarray(data[:, ::stride]) if stride > 1 else data
    interior = np.abs(sub).min(axis=0) > 0  # rows where every tap is active
    if stride > 1 and interior.mean() < 0.01:
        # anomalously thin sampled interior → the full scan
        sub = data
        interior = np.abs(sub).min(axis=0) > 0
    if not interior.any():
        interior = np.ones(sub.shape[1], bool)
    med = np.array([float(np.median(sub[k][interior]))
                    for k in range(len(offsets))])
    return strong_axes_from_values(offsets, med, dims, theta)
