"""Sparse operator containers and host converters.

Counterpart of ``omp_amg_tpu/sparse/formats.py`` (``Dia``, ``Csr``,
``ConstDia`` and the host ELL/DIA/scipy helpers the setups use).

- ``Dia``: banded storage with static offsets, ``data[k, i]`` multiplies
  ``x[i + offsets[k]]``, out-of-range slots are exactly 0. ``data`` is a
  numpy array (host operators from :mod:`omp_amg_tpu_torch.problems`) or a
  torch tensor (device operators, f32 or lossless bf16).
- ``Csr``: device CSR (``indptr`` int64, ``indices`` int32, values f32 or
  bf16) for the general-sparsity levels (coarse A, P, R). On the GPU a gather
  is an ordinary load, so CSR replaces the reference's ELL and routed-ELL
  device forms.
- ``ConstDia``: a matrix-free masked-constant 3D stencil (coefficients and
  taps only). The reference's ``(nmask, plane/128, 128)`` validity masks
  exist for the TPU's VMEM lanes; here a tap's validity is index arithmetic
  on (z, y, x), so no mask array is kept.

The host helpers stay numpy/scipy: padded ELL planes use ``col=0, val=0``
padding, as in the reference.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Dia:
    """Banded (diagonal) operator with static offsets (square)."""

    data: object                        # (ndiag, n) np.ndarray | torch.Tensor
    offsets: Tuple[int, ...]
    dims: Tuple[int, ...] | None = None

    @property
    def n_rows(self) -> int:
        return int(self.data.shape[1])

    @functools.cached_property
    def offsets_i32(self) -> ctypes.Array:
        """The offsets as a host int32 ctypes array: the DIA kernel's launch
        copies them into its parameter block."""
        return (ctypes.c_int32 * len(self.offsets))(*self.offsets)


@dataclass(frozen=True)
class Csr:
    """Compressed sparse rows on a torch device."""

    indptr: torch.Tensor    # (n_rows + 1,) int64
    indices: torch.Tensor   # (nnz,) int32
    vals: torch.Tensor      # (nnz,) float32 | bfloat16
    n_cols: int

    @property
    def n_rows(self) -> int:
        return self.indptr.numel() - 1

    @property
    def nnz(self) -> int:
        return self.indices.numel()

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @functools.cached_property
    def vec(self) -> int:
        """Lanes per row of the CSR kernel: the largest power of two at or
        below half the mean row length ``nnz / n_rows``, from 1 to 32 (a
        warp). Each lane then takes about two nonzeros of a row: on the H100
        a lane per nonzero or more spends more instructions per row than the
        loads it saves (``PERF.md``). A host rule on the sizes, so it needs
        no device sync."""
        v = 1
        while v < 32 and 4 * v * max(self.n_rows, 1) <= self.nnz:
            v *= 2
        return v


@dataclass(frozen=True)
class ConstDia:
    """Matrix-free masked-constant stencil operator on a 3D grid:
    ``A[i, i + offsets[k]] = coeffs[k]`` wherever tap ``taps[k] = (dz, dy,
    dx)`` stays inside ``dims = (nz, ny, nx)``, else 0. A SpMV streams the
    vectors only."""

    coeffs: Tuple[float, ...]                # per-tap constant (f32 values)
    offsets: Tuple[int, ...]                 # flat diagonal offsets
    taps: Tuple[Tuple[int, int, int], ...]   # (dz, dy, dx) per offset
    dims: Tuple[int, int, int]               # (nz, ny, nx)
    device: torch.device = torch.device("cpu")

    @property
    def n_rows(self) -> int:
        nz, ny, nx = self.dims
        return nz * ny * nx

    @property
    def n_cols(self) -> int:
        return self.n_rows

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_rows)

    @functools.cached_property
    def operand(self) -> Tuple[np.ndarray, np.ndarray]:
        """The kernel operand: (taps int32 (m, 3), coeffs f32 (m,)) of the
        taps with a nonzero coefficient, in ascending offset order (host
        arrays; the kernel receives them by value)."""
        keep = [k for k, c in enumerate(self.coeffs) if c != 0.0]
        taps = np.array([self.taps[k] for k in keep], np.int32).reshape(-1, 3)
        coeffs = np.array([self.coeffs[k] for k in keep], np.float32)
        return taps, coeffs


def const_masks(taps, dims, device) -> list:
    """Per-tap validity masks (bool, length n) by index arithmetic: tap
    (dz, dy, dx) is valid at row (z, y, x) iff it stays inside the grid."""
    nz, ny, nx = dims
    idx = torch.arange(nz * ny * nx, dtype=torch.int64, device=device)
    xi = idx % nx
    yi = (idx // nx) % ny
    zi = idx // (nx * ny)
    return [(xi + dx >= 0) & (xi + dx < nx) & (yi + dy >= 0) & (yi + dy < ny)
            & (zi + dz >= 0) & (zi + dz < nz) for dz, dy, dx in taps]


def _tap_decompose(d: int, dims) -> Tuple[int, int, int] | None:
    """Flat diagonal offset → (dz, dy, dx) grid tap (minimal L1 norm)."""
    nz, ny, nx = dims
    plane = ny * nx
    best = None
    for dz in (-1, 0, 1):
        for dy in range(-8, 9):
            dx = d - dz * plane - dy * nx
            if abs(dx) <= 8:
                cand = (abs(dz) + abs(dy) + abs(dx), dz, dy, dx)
                if best is None or cand < best:
                    best = cand
    return None if best is None else best[1:]


def to_const_dia(a: Dia, device) -> ConstDia | None:
    """Host ``Dia`` (numpy data) → ``ConstDia`` on ``device`` when the
    operator is a masked-constant 3D stencil, else None.

    The reference's detection rule, unchanged, so that both packages choose
    the same form at every level: 3D dims, ``ny·nx % 128 == 0`` (a rule born
    of the TPU's 128 lanes, kept for parity), every offset a tap within
    ±1 plane and ±8 rows/columns, an interior row to sample the coefficients
    from, and an exact box check of every diagonal (the value on the tap's
    valid box, 0 off it). Galerkin coarse operators fail the check: their
    boundary values are modified, not merely zeroed.
    """
    if a.dims is None or len(a.dims) != 3:
        return None
    nz, ny, nx = (int(d) for d in a.dims)
    dims = (nz, ny, nx)
    if (ny * nx) % 128 != 0:
        return None
    taps = []
    for d in a.offsets:
        t = _tap_decompose(int(d), dims)
        if t is None:
            return None
        taps.append(t)
    zm, ym, xm = nz // 2, ny // 2, nx // 2
    for dz, dy, dx in taps:
        if not (0 <= zm + dz < nz and 0 <= ym + dy < ny and 0 <= xm + dx < nx):
            return None  # grid too small to sample an interior coefficient
    data = np.asarray(a.data)
    mid = (zm * ny + ym) * nx + xm
    coeffs = tuple(float(v) for v in data[:, mid])
    for k, ((dz, dy, dx), c) in enumerate(zip(taps, coeffs)):
        v = data[k].reshape(nz, ny, nx)
        c = data.dtype.type(c)
        box = v[max(0, -dz):nz - max(0, dz),
                max(0, -dy):ny - max(0, dy),
                max(0, -dx):nx - max(0, dx)]
        if not np.all(box == c):
            return None
        if np.count_nonzero(v) != (box.size if c != 0 else 0):
            return None
    # the concrete device ("cuda" → "cuda:0"), as the vectors will carry it
    device = torch.empty(0, device=device).device
    return ConstDia(coeffs=coeffs, offsets=tuple(int(o) for o in a.offsets),
                    taps=tuple(taps), dims=dims, device=device)


def const_to_dia(a: ConstDia) -> Dia:
    """Materialize the f32 DIA planes of a ``ConstDia`` on its device."""
    zero = torch.zeros((), dtype=torch.float32, device=a.device)
    data = torch.stack([
        torch.where(m, torch.tensor(c, dtype=torch.float32, device=a.device),
                    zero)
        for c, m in zip(a.coeffs, const_masks(a.taps, a.dims, a.device))])
    return Dia(data=data, offsets=a.offsets, dims=a.dims)


def bf16_lossless(values: np.ndarray) -> bool:
    """True iff every value is exactly representable in bfloat16 (the
    lossless-compression test of the reference's ``to_plane_dia``: cast,
    cast back, compare)."""
    t = torch.from_numpy(np.ascontiguousarray(values, np.float32))
    return bool(torch.equal(t.to(torch.bfloat16).to(torch.float32), t))


def dia_to_device(a: Dia, device) -> Dia:
    """Device form of a banded operator: diagonal-major (ndiag, n) values in
    bf16 when that cast is lossless (exact for the Poisson stencils), else
    f32."""
    data32 = np.array(_numpy(a.data), np.float32)     # an owned copy
    t = torch.from_numpy(data32)
    if bf16_lossless(data32):
        t = t.to(torch.bfloat16)
    return Dia(data=t.to(device), offsets=tuple(int(o) for o in a.offsets),
               dims=a.dims)


def csr_from_scipy(m, dtype=torch.float32, *, device) -> Csr:
    """scipy sparse → device ``Csr``. Values round f64 → f32 (→ bf16 when
    ``dtype`` is bfloat16, round to nearest even)."""
    import scipy.sparse as sp

    m = sp.csr_matrix(m)
    vals = torch.from_numpy(np.ascontiguousarray(m.data, np.float32))
    return Csr(
        indptr=torch.from_numpy(np.asarray(m.indptr, np.int64)).to(device),
        indices=torch.from_numpy(np.asarray(m.indices, np.int32)).to(device),
        vals=vals.to(dtype).to(device),
        n_cols=int(m.shape[1]))


def csr_from_ell(col: np.ndarray, val: np.ndarray, n_cols: int,
                 device) -> Csr:
    """Padded ELL planes → ``Csr``, dropping the padding (val == 0) and
    keeping each row's slot order and the value dtype."""
    col = np.asarray(col)
    val = np.asarray(val)
    valid = val != 0
    indptr = np.zeros(col.shape[0] + 1, np.int64)
    np.cumsum(valid.sum(axis=1), out=indptr[1:])
    return Csr(indptr=torch.from_numpy(indptr).to(device),
               indices=torch.from_numpy(
                   np.ascontiguousarray(col[valid], np.int32)).to(device),
               vals=torch.from_numpy(np.ascontiguousarray(val[valid])).to(
                   device),
               n_cols=int(n_cols))


def _numpy(data) -> np.ndarray:
    if isinstance(data, torch.Tensor):
        return data.detach().to("cpu", torch.float64).numpy()
    return np.asarray(data)


# ---------------------------------------------------------------------------
# Host-side converters (numpy & scipy; setup phase only)
# ---------------------------------------------------------------------------

def ell_planes_from_scipy(a, width: int | None = None, dtype=np.float32):
    """Host numpy (col, val, n_cols) padded ELL planes from a scipy matrix."""
    import scipy.sparse as sp

    a = sp.csr_matrix(a)
    # canonical setup-chain operators (Galerkin products, generators) are
    # already zero-free and sorted — skip the copy/eliminate/sort passes
    owned = False
    if a.nnz and (a.data == 0).any():
        a = a.copy()
        owned = True
        a.eliminate_zeros()  # ELL uses val==0 as the padding sentinel
    if not a.has_sorted_indices:
        if not owned:
            # sp.csr_matrix(csr) shares the index/data arrays — sorting in
            # place would silently canonicalize the CALLER's matrix
            a = a.copy()
        a.sort_indices()
    n_rows, n_cols = a.shape
    lengths = np.diff(a.indptr)
    k = int(lengths.max(initial=0)) if width is None else int(width)
    if lengths.max(initial=0) > k:
        raise ValueError(f"row length {lengths.max()} exceeds ELL width {k}")
    if np.dtype(dtype) == np.float32 and a.data.dtype == np.float64:
        from .. import native

        # parallel native fill; its (float) cast per entry == the numpy
        # fill's rounding
        out = native.ell_fill(a, k)
        if out is not None:
            return out[0], out[1], int(n_cols)
    col = np.zeros((n_rows, max(k, 1)), dtype=np.int32)
    val = np.zeros((n_rows, max(k, 1)), dtype=dtype)
    pos = np.arange(a.nnz, dtype=np.int64) - np.repeat(
        a.indptr[:-1].astype(np.int64), lengths)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), lengths)
    col[rows, pos] = a.indices
    val[rows, pos] = a.data
    return col, val, int(n_cols)


def ell_planes_to_scipy(col: np.ndarray, val: np.ndarray, n_cols: int):
    """Direct CSR from padded ELL planes.

    Relies on the invariant that a row's valid slots carry distinct column
    indices (padding is val==0), so no duplicate summing is needed.
    """
    import scipy.sparse as sp

    col = np.asarray(col)
    val = np.asarray(val, np.float64)
    n, k = col.shape
    valid = val != 0
    lengths = valid.sum(axis=1)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=indptr[1:])
    m = sp.csr_matrix((val[valid], col[valid].astype(np.int64), indptr),
                      shape=(n, n_cols))
    m.sort_indices()
    return m


def dia_to_scipy(a: Dia):
    """scipy CSR (f64) of a banded operator."""
    import scipy.sparse as sp

    n = a.n_rows
    data = np.asarray(_numpy(a.data), dtype=np.float64)
    # scipy dia convention: data[k, j] is the value at column j (row j-off);
    # ours: data[k, i] multiplies x[i+off] at row i → shift each diagonal.
    sdata = np.zeros_like(data)
    for k, off in enumerate(a.offsets):
        i0, i1 = max(0, -off), min(n, n - off)
        sdata[k, i0 + off: i1 + off] = data[k, i0:i1]
    m = sp.dia_matrix((sdata, np.asarray(a.offsets)), shape=(n, n)).tocsr()
    m.eliminate_zeros()
    m.sort_indices()
    return m


def dia_planes_from_scipy(a):
    """(offsets, f64 numpy planes) of a square banded scipy matrix, through
    scipy's ``dia_matrix``."""
    import scipy.sparse as sp

    d = sp.dia_matrix(a)
    n = d.shape[0]
    if d.shape[0] != d.shape[1]:
        raise ValueError("Dia requires a square matrix")
    offsets = [int(o) for o in d.offsets]
    # scipy's data[k, j] multiplies x[j] for row j − off; ours data[k, i]
    # multiplies x[i + off] for row i → ours[k, i] = scipy[k, i + off]
    out = np.zeros((len(offsets), n), dtype=np.float64)
    for k, off in enumerate(offsets):
        i0, i1 = max(0, -off), min(n, n - off)
        out[k, i0:i1] = d.data[k, i0 + off:i1 + off]
    return offsets, out


def ell_planes_from_dia(a: Dia, dtype=np.float32):
    """Padded ELL (col, val) planes straight from DIA diagonals.

    col[i, k] = i + offsets[k] (clipped; padding keeps val == 0 by the DIA
    masked-zero invariant); slot k is diagonal k, so valid slots are not
    compacted — every consumer treats val == 0 as padding anywhere.
    """
    n = a.n_rows
    offs = np.asarray(a.offsets, np.int64)
    col = np.arange(n, dtype=np.int64)[:, None] + offs[None, :]
    np.clip(col, 0, n - 1, out=col)
    val = np.ascontiguousarray(np.asarray(_numpy(a.data), dtype).T)
    col = col.astype(np.int32)
    col[val == 0] = 0
    return col, val, n
