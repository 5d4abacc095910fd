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
- ``TileCsr``: the tiled form of a ``Csr`` with long rows whose neighbouring
  rows share their columns (the coarse PMIS A): tiles of consecutive rows,
  each with the sorted list of its distinct columns, and 16-bit column
  indices into the tile's list. ``tile_rule`` is the rule that gives it,
  ``tiled_form`` applies the rule on the card, ``tile_csr`` builds the form
  on the operator's device, ``tile_to_csr`` decodes.
- ``ConstDia``: a matrix-free masked-constant 3D stencil (coefficients and
  taps only). The reference's ``(nmask, plane/128, 128)`` validity masks
  exist for the TPU's VMEM lanes; here a tap's validity is index arithmetic
  on (z, y, x), so no mask array is kept.

The public storage API of the reference, on ``Csr`` and ``Dia``:
``coo_to_csr`` (duplicates summed), ``csr_from_scipy``, ``csr_to_scipy``,
``dia_from_scipy``, ``dia_to_csr``, ``dia_to_scipy`` and ``diagonal``; the
constructors put the operator on the card unless told ``device="cpu"``.
The reference's ``Ell`` is not ported: ELL is the TPU's padded layout, and
``Csr`` serves on the card.

The host helpers stay numpy/scipy: padded ELL planes use ``col=0, val=0``
padding, as in the reference. The device-flavor setups take the same
planes of a device operator where it lies (``ell_planes``), compact P's
planes there (``csr_from_ell`` on tensors) and check a device ``Dia`` for
the constant-stencil form there (``to_const_dia``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..utils.device import resolve_device


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
        """Lanes per row of the CSR kernel (:func:`lanes_per_row`)."""
        return lanes_per_row(self.n_rows, self.nnz)


def lanes_per_row(n_rows: int, nnz: int) -> int:
    """Lanes per row of the CSR and tiled-CSR kernels: the largest power of
    two at or below half the mean row length ``nnz / n_rows``, from 1 to 32
    (a warp). Each lane then takes about two nonzeros of a row: on the H100
    a lane per nonzero or more spends more instructions per row than the
    loads it saves (``PERF.md``). A host rule on the sizes, so it needs no
    device sync."""
    v = 1
    while v < 32 and 4 * v * max(n_rows, 1) <= nnz:
        v *= 2
    return v


@dataclass(frozen=True)
class TileCsr:
    """Tiled CSR: a ``Csr`` whose rows are cut into tiles of consecutive
    rows, each tile holding the sorted distinct global columns its rows
    touch (``tile_cols[tile_ptr[t]:tile_ptr[t + 1]]``), and each nonzero a
    16-bit index into its tile's list (``indices``, int16 storage read as
    unsigned). ``indptr`` and ``vals`` are the CSR's, in its nonzero order
    and value type, so a refresh's new values drop in unchanged. The tiled
    kernel (``ops/tile_csr.py``) holds a tile's x window ``x[tile_cols]`` in
    shared memory; ``window`` is the most distinct columns of a tile. Made
    by :func:`tile_csr`, undone by :func:`tile_to_csr`."""

    indptr: torch.Tensor     # (n_rows + 1,) int64
    indices: torch.Tensor    # (nnz,) int16: column within the tile's list
    vals: torch.Tensor       # (nnz,) float32 | bfloat16
    n_cols: int
    tile_rows: torch.Tensor  # (n_tiles + 1,) int64: first row of each tile
    tile_ptr: torch.Tensor   # (n_tiles + 1,) int64: into tile_cols
    tile_cols: torch.Tensor  # (Σ distinct,) int32: sorted within a tile
    window: int              # the most distinct columns of a tile

    @property
    def n_rows(self) -> int:
        return self.indptr.numel() - 1

    @property
    def nnz(self) -> int:
        return self.indices.numel()

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def n_tiles(self) -> int:
        return self.tile_rows.numel() - 1

    @property
    def unique_share(self) -> float:
        """Distinct columns summed over the tiles, over the nonzeros: the
        share of the nonzeros whose x the kernel gathers from memory."""
        return self.tile_cols.numel() / max(self.nnz, 1)

    @functools.cached_property
    def vec(self) -> int:
        """Lanes per row (:func:`lanes_per_row`), as the CSR kernel's."""
        return lanes_per_row(self.n_rows, self.nnz)


# The tiled form's rule (``tile_rule``), from the H100 (PERF.md §6): rows
# of at least this mean length (V ≥ 8 lanes), operators of at least this
# many nonzeros, and tiles whose distinct columns are at most this share of
# their nonzeros. The size: the tiled kernel took 0.72–0.90× the CSR
# kernel's time on the coarse A from 27 M nonzeros up, but 0.95–1.16× from
# 7.9 M to 13.3 M (the 27-point 128³ A₁ 1.01–1.16×) and 1.3–3.3× at
# 3.3 M and below, where too few tiles fill the card
TILE_MIN_ROW_LEN = 16
TILE_MIN_NNZ = 1 << 24
TILE_MAX_UNIQUE_SHARE = 1 / 3
# a tile: at most this many distinct columns (its x window, f32 in shared
# memory, 24 KiB) and about this many nonzeros (the fastest of the shapes
# timed at 256³: 2,048–12,288 columns, 8–32 k nonzeros); a 16-bit index
# reaches 65,536 columns
TILE_WINDOW = 6144
TILE_NNZ = 1 << 14
TILE_MAX_COLS = 1 << 16
_BUILD_CHUNK = 1 << 24        # nonzeros sorted at once by the builder


def _tile_rows(indptr: torch.Tensor, target: int) -> torch.Tensor:
    """First rows of tiles of about ``target`` nonzeros: row r opens a tile
    where ``indptr[r] // target`` steps; the last row is appended."""
    n = indptr.numel() - 1
    key = torch.div(indptr[:-1], target, rounding_mode="floor")
    opens = torch.ones(n, dtype=torch.bool, device=indptr.device)
    opens[1:] = key[1:] != key[:-1]
    ends = torch.tensor([n], dtype=torch.int64, device=indptr.device)
    return torch.cat([opens.nonzero().squeeze(1), ends])


def _local_columns(a: Csr, tile_rows: torch.Tensor):
    """(16-bit local indices, stored as int16, distinct columns per tile,
    the sorted distinct columns) of ``a``'s nonzeros on the tiles
    ``tile_rows``: sorts of (tile, column) keys, ``_BUILD_CHUNK`` nonzeros
    of whole tiles at a time (the int64 temporaries of one chunk at a
    time). A tile of more than 65,536 columns gives wrapped indices: the
    caller splits it."""
    dev = a.indptr.device
    bounds = a.indptr[tile_rows]                       # nonzero bounds
    tnnz = bounds.diff()
    # whole tiles per chunk: a tile joins the chunk its first nonzero is in
    cut = torch.div(bounds[:-1], _BUILD_CHUNK, rounding_mode="floor")
    first = torch.ones_like(cut, dtype=torch.bool)
    first[1:] = cut[1:] != cut[:-1]
    chunk_tiles = torch.cat([first.nonzero().squeeze(1),
                             torch.tensor([cut.numel()], device=dev)]).tolist()
    local, counts, cols = [], [], []
    for t0, t1 in zip(chunk_tiles[:-1], chunk_tiles[1:]):
        s, e = int(bounds[t0]), int(bounds[t1])
        tile = torch.repeat_interleave(
            torch.arange(t1 - t0, device=dev), tnnz[t0:t1],
            output_size=e - s)
        keys = tile * a.n_cols + a.indices[s:e].long()
        uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
        cnt = torch.bincount(torch.div(uniq, a.n_cols, rounding_mode="floor"),
                             minlength=t1 - t0)
        start = torch.cumsum(cnt, 0) - cnt
        # uint16 values in int16 storage (the kernel reads them unsigned)
        li = (inv - start[tile]).to(torch.int32)
        local.append(torch.where(li >= 1 << 15, li - (1 << 16),
                                 li).to(torch.int16))
        counts.append(cnt)
        cols.append((uniq % a.n_cols).to(torch.int32))
    return torch.cat(local), torch.cat(counts), torch.cat(cols)


def tile_csr(a: Csr, window: int = TILE_WINDOW,
             nnz: int = TILE_NNZ) -> TileCsr | None:
    """The tiled form of ``a``, built where its tensors lie (torch sorts of
    (tile, column) keys; nothing but sizes and counts reaches the host).
    Tiles start at about ``nnz`` nonzeros; a tile whose distinct columns
    pass ``window`` (or the 16-bit index's ``TILE_MAX_COLS``) is halved by
    rows until none does. None for an empty operator or a single row past
    the limit."""
    if a.n_rows == 0 or a.nnz == 0:
        return None
    limit = min(window, TILE_MAX_COLS)
    tile_rows = _tile_rows(a.indptr, nnz)
    while True:
        local, counts, cols = _local_columns(a, tile_rows)
        bad = (counts > limit).nonzero().squeeze(1)
        if bad.numel() == 0:
            break
        b0, b1 = tile_rows[bad], tile_rows[bad + 1]
        if bool((b1 - b0 < 2).any()):
            return None
        tile_rows = torch.sort(torch.cat([
            tile_rows, torch.div(b0 + b1, 2, rounding_mode="floor")])).values
    tile_ptr = torch.zeros(counts.numel() + 1, dtype=torch.int64,
                           device=a.indptr.device)
    torch.cumsum(counts, 0, out=tile_ptr[1:])
    return TileCsr(indptr=a.indptr, indices=local,
                   vals=a.vals, n_cols=a.n_cols, tile_rows=tile_rows,
                   tile_ptr=tile_ptr, tile_cols=cols,
                   window=int(counts.max()))


def tile_to_csr(t: TileCsr) -> Csr:
    """The global ``Csr`` of a tiled operator (the same ``indptr`` and
    ``vals`` tensors, int32 global columns decoded from the tiles)."""
    if not isinstance(t, TileCsr):
        return t
    dev = t.indptr.device
    tile_nnz = t.indptr[t.tile_rows].diff()
    tile = torch.repeat_interleave(torch.arange(t.n_tiles, device=dev),
                                   tile_nnz, output_size=t.nnz)
    local = t.indices.long() & 0xFFFF
    cols = t.tile_cols[t.tile_ptr[tile] + local]
    return Csr(indptr=t.indptr, indices=cols.to(torch.int32), vals=t.vals,
               n_cols=t.n_cols)


def tile_rule(op) -> TileCsr | None:
    """The rule that picks the form of a level's A or R, on the operator
    alone: its tiled form where rows average at least ``TILE_MIN_ROW_LEN``
    nonzeros, the operator holds at least ``TILE_MIN_NNZ``, and its tiles'
    distinct columns are at most ``TILE_MAX_UNIQUE_SHARE`` of its nonzeros;
    else None (any other operator, or a ``TileCsr`` already)."""
    if not isinstance(op, Csr) or op.nnz < TILE_MIN_NNZ \
            or op.nnz < TILE_MIN_ROW_LEN * op.n_rows:
        return None
    t = tile_csr(op)
    if t is None or t.unique_share > TILE_MAX_UNIQUE_SHARE:
        return None
    return t


def tiled_form(op):
    """A level's A or R in the form it runs in: :func:`tile_rule`'s tiled
    form of a ``Csr`` on a CUDA device, else ``op`` unchanged. On the CPU
    the form has no kernel: its twin would decode every column on each
    apply."""
    if not isinstance(op, Csr) or op.indptr.device.type != "cuda":
        return op
    t = tile_rule(op)
    return op if t is None else t


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


@functools.lru_cache(maxsize=4096)
def _tap_decompose(d: int, dims) -> Tuple[int, int, int] | None:
    """Flat diagonal offset → (dz, dy, dx) grid tap (minimal L1 norm);
    cached: a refresh asks again for every level."""
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


@functools.lru_cache(maxsize=256)
def _tap_boxes(taps, dims, device) -> torch.Tensor:
    """(taps, nz + ny + nx) bool on ``device``: per tap and axis, the grid
    points whose neighbour along the tap lies on the grid (the tap's box,
    axis by axis). Cached: a host array copied to the card waits for the
    device's queue."""
    boxes = np.zeros((len(taps), sum(dims)), bool)
    for k, t in enumerate(taps):
        lo = 0
        for n_ax, d_ax in zip(dims, t):
            boxes[k, lo + max(0, -d_ax):lo + n_ax - max(0, d_ax)] = True
            lo += n_ax
    return torch.from_numpy(boxes).to(device)


def const_shape(a: Dia):
    """``(taps, dims, mid)`` where the shape of ``a`` lets it be a
    masked-constant 3D stencil (the first part of :func:`to_const_dia`'s
    rule: 3D dims, ``ny·nx % 128 == 0``, every offset a tap within ±1
    plane and ±8 rows/columns, an interior row ``mid`` to sample the
    coefficients from), else None."""
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
    return tuple(taps), dims, (zm * ny + ym) * nx + xm


def const_check(data: torch.Tensor, shape) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """``(col, ok)`` for torch planes ``data`` of the shape ``shape``
    (:func:`const_shape`), where they lie and with no host read: the
    sampled coefficients and whether every plane holds its coefficient on
    its box and 0 off it (a 0-d bool), in a few launches."""
    taps, dims, mid = shape
    col = data[:, mid]
    bz, by, bx = _tap_boxes(taps, dims, data.device).split(dims, dim=1)
    box = (bz[:, :, None, None] & by[:, None, :, None]
           & bx[:, None, None, :])
    want = torch.where(box, col[:, None, None, None], 0.0)
    return col, (data.reshape(want.shape) == want).all()


def to_const_dia(a: Dia, device=None, checked=None) -> ConstDia | None:
    """``Dia`` → ``ConstDia`` on ``device`` (default: the planes' device for
    torch planes, the card for numpy planes) when the operator is a
    masked-constant 3D stencil, else None. Raises RuntimeError when the
    device is CUDA and CUDA is not available.

    The reference's detection rule, unchanged, so that both packages choose
    the same form at every level: the shape (:func:`const_shape`), and an
    exact box check of every diagonal (the value on the tap's valid box, 0
    off it). Galerkin coarse operators fail the check: their boundary
    values are modified, not merely zeroed. Torch planes are checked where
    they lie (:func:`const_check`): only the sampled coefficients and one
    bool reach the host. ``checked``: those two, as host values, from a
    check already made on these planes.
    """
    on_device = isinstance(a.data, torch.Tensor)
    if device is None:
        device = a.data.device if on_device else "cuda"
    # the concrete device ("cuda" → "cuda:0"), as the vectors will carry it
    device = resolve_device(device)
    device = torch.empty(0, device=device).device
    shape = const_shape(a)
    if shape is None:
        return None
    taps, dims, mid = shape
    nz, ny, nx = dims
    if checked is not None:
        coeffs, ok = checked
        if not ok:
            return None
    elif on_device:
        # every plane at once: its coefficient on its box and 0 off it, the
        # same test as the host's (the box all c, nonzeros only there)
        col, ok = const_check(a.data, shape)
        coeffs = tuple(float(v) for v in col.double().cpu())
        if not bool(ok):
            return None
    else:
        data = np.asarray(a.data)
        coeffs = tuple(float(v) for v in data[:, mid])
        for k, ((dz, dy, dx), c) in enumerate(zip(taps, coeffs)):
            v = data[k].reshape(nz, ny, nx)
            box = v[max(0, -dz):nz - max(0, dz),
                    max(0, -dy):ny - max(0, dy),
                    max(0, -dx):nx - max(0, dx)]
            if not (np.all(box == data.dtype.type(c))
                    and np.count_nonzero(v) == (box.size if c else 0)):
                return None
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


def bf16_check(t: torch.Tensor) -> torch.Tensor:
    """Whether every value of ``t`` is exact in bfloat16, as a 0-d bool where
    ``t`` lies (no host read)."""
    return (t.to(torch.bfloat16).to(torch.float32) == t).all()


def dia_to_device(a: Dia, device, lossless=None) -> Dia:
    """Device form of a banded operator: diagonal-major (ndiag, n) values in
    bf16 when that cast is lossless (exact for the Poisson stencils), else
    f32. Torch planes are converted and checked on ``device``, without a
    host round trip. ``lossless``: that check (:func:`bf16_check`) already
    made on these planes, as a host bool."""
    if isinstance(a.data, torch.Tensor):
        t = a.data.to(device, torch.float32)
        if (lossless if lossless is not None else
                torch.equal(t.to(torch.bfloat16).to(torch.float32), t)):
            t = t.to(torch.bfloat16)
    else:
        data32 = np.array(a.data, np.float32)     # an owned copy
        t = torch.from_numpy(data32)
        if bf16_lossless(data32):
            t = t.to(torch.bfloat16)
        t = t.to(device)
    return Dia(data=t, offsets=tuple(int(o) for o in a.offsets), dims=a.dims)


def csr_from_scipy(m, dtype=torch.float32, device="cuda") -> Csr:
    """scipy sparse → device ``Csr``. Values round f64 → f32 (→ bf16 when
    ``dtype`` is bfloat16, round to nearest even)."""
    import scipy.sparse as sp

    device = resolve_device(device)
    m = sp.csr_matrix(m)
    vals = torch.from_numpy(np.ascontiguousarray(m.data, np.float32))
    return Csr(
        indptr=torch.from_numpy(np.asarray(m.indptr, np.int64)).to(device),
        indices=torch.from_numpy(np.asarray(m.indices, np.int32)).to(device),
        vals=vals.to(dtype).to(device),
        n_cols=int(m.shape[1]))


def csr_to_scipy(a: Csr | TileCsr):
    """scipy CSR (f64) of a device ``Csr`` (or ``TileCsr``, decoded)."""
    import scipy.sparse as sp

    a = tile_to_csr(a)
    return sp.csr_matrix((a.vals.detach().to("cpu", torch.float64).numpy(),
                          a.indices.cpu().numpy(), a.indptr.cpu().numpy()),
                         shape=a.shape)


def coo_to_csr(rows, cols, vals, shape, dtype=torch.float32,
               device="cuda") -> Csr:
    """COO assembly → ``Csr``, duplicate entries summed (in f64, before the
    cast to ``dtype``), as the reference's COO → CSR path."""
    import scipy.sparse as sp

    a = sp.coo_matrix((np.asarray(vals, np.float64),
                       (np.asarray(rows), np.asarray(cols))), shape=shape)
    return csr_from_scipy(a.tocsr(), dtype=dtype, device=device)


def csr_from_ell(col, val, n_cols: int, device=None) -> Csr:
    """Padded ELL planes (numpy arrays or tensors) → ``Csr`` on ``device``
    (default: the planes' device for tensors, the card for numpy planes),
    dropping the padding (val == 0) and keeping each row's slot order and
    the value dtype. Tensor planes are compacted where they lie (indptr
    from a cumulative sum). Raises RuntimeError when the device is CUDA and
    CUDA is not available."""
    if isinstance(col, torch.Tensor):
        device = resolve_device(col.device if device is None else device)
        valid = val != 0
        indptr = torch.zeros(col.shape[0] + 1, dtype=torch.int64,
                             device=col.device)
        torch.cumsum(valid.sum(dim=1), 0, out=indptr[1:])
        return Csr(indptr=indptr.to(device),
                   indices=col[valid].to(device, torch.int32),
                   vals=val[valid].to(device), n_cols=int(n_cols))
    device = resolve_device("cuda" if device is None else device)
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


def ell_planes(a: Dia | Csr):
    """Padded ELL planes ``(col, val)`` of a device operator, (n, K) int32
    and f32 on its device, without a host round trip. From a ``Dia`` slot
    k is diagonal k, ``col = i + offsets[k]``; from a ``Csr`` the slots are
    each row's entries in CSR order and K the longest row. Padding is
    ``col = 0, val = 0``, as in the host planes, and an exact zero anywhere
    counts as padding."""
    if isinstance(a, Dia):
        data = a.data
        n = a.n_rows
        offs = torch.tensor(a.offsets, dtype=torch.int64, device=data.device)
        col = torch.arange(n, dtype=torch.int64, device=data.device)[:, None]
        col = (col + offs[None, :]).clamp_(0, max(n - 1, 0))
        val = data.to(torch.float32).t().contiguous()
    else:
        n, dev = a.n_rows, a.vals.device
        lengths = a.indptr.diff()
        k = max(int(lengths.max()) if n else 0, 1)
        rows = torch.repeat_interleave(torch.arange(n, device=dev), lengths,
                                       output_size=a.nnz)
        pos = torch.arange(a.nnz, device=dev) - torch.repeat_interleave(
            a.indptr[:-1], lengths, output_size=a.nnz)
        col = torch.zeros((n, k), dtype=torch.int64, device=dev)
        val = torch.zeros((n, k), dtype=torch.float32, device=dev)
        col[rows, pos] = a.indices.long()
        val[rows, pos] = a.vals.float()
    return torch.where(val != 0, col, 0).to(torch.int32), val


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


def dia_from_scipy(a, dtype=torch.float32, device="cuda") -> Dia:
    """A square banded scipy matrix → device ``Dia`` (values in ``dtype``,
    one plane per stored diagonal)."""
    offsets, planes = dia_planes_from_scipy(a)
    data = torch.from_numpy(planes).to(dtype)
    return Dia(data=data.to(resolve_device(device)), offsets=tuple(offsets))


def dia_to_csr(a: Dia, device=None) -> Csr:
    """``Csr`` of a banded operator, its values in the planes' dtype (f32 for
    host planes), on ``device`` (default: the planes' device, or the card
    for host planes)."""
    data = a.data
    dtype = data.dtype if isinstance(data, torch.Tensor) else torch.float32
    if device is None:
        device = data.device if isinstance(data, torch.Tensor) else "cuda"
    return csr_from_scipy(dia_to_scipy(a), dtype=dtype, device=device)


def diagonal(a):
    """The main diagonal of a ``Dia`` (its centre plane: a tensor, or a
    numpy array for host planes), a ``ConstDia`` (f32, constant) or a
    ``Csr`` or ``TileCsr`` (a device op: each row's diagonal entries
    summed, in f32, then cast to the values' dtype)."""
    if isinstance(a, ConstDia):
        c = a.coeffs[a.offsets.index(0)] if 0 in a.offsets else 0.0
        return torch.full((a.n_rows,), c, dtype=torch.float32,
                          device=a.device)
    if isinstance(a, Dia):
        if 0 in a.offsets:
            return a.data[a.offsets.index(0)]
        if isinstance(a.data, torch.Tensor):
            return a.data.new_zeros(a.n_rows)
        return np.zeros(a.n_rows, a.data.dtype)
    if isinstance(a, (Csr, TileCsr)):
        a = tile_to_csr(a)
        n = a.n_rows
        rows = torch.repeat_interleave(
            torch.arange(n, device=a.vals.device), a.indptr.diff(),
            output_size=a.nnz)
        hit = torch.where(a.indices.long() == rows, a.vals.float(), 0.0)
        return torch.zeros(n, dtype=torch.float32,
                           device=a.vals.device).index_add_(
            0, rows, hit).to(a.vals.dtype)
    raise TypeError(f"no diagonal for {type(a).__name__}")


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
