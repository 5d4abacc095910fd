"""Matrix-free constant-stencil SpMV: the hand-written CUDA kernel, its plain
twin, the wrappers and their launch counter.

Counterpart of ``omp_amg_tpu/ops/pallas_const.py::_const_kernel`` (entry
points ``spmv_const``, ``residual_const``, ``jacobi_const``,
``presmooth_residual_const`` and ``correct_jacobi_const``; XLA twin
``ops/spmv.py::spmv_const_xla``); the kernel is
``omp_amg_tpu_torch/csrc/const_stencil.cu``. The operator is a
``ConstDia``; vectors and results are f32; ``s`` is the Jacobi scale ω·D⁻¹,
one f32 number because the diagonal of a constant stencil is constant.

Modes (x carries b in zjr and cja, as in the TPU kernel):

- spmv ``A·x``; residual ``b − A·x``; jacobi ``x + s·(b − A·x)``;
- zjr ``b − s·(A·b)``: pre-smooth from zero and residual of a V(1,1) level;
- cja ``u + s·(b − A·u)`` with ``u = s·b + p``: coarse-grid correction p
  and post-smooth.

The kernel marches along z: a block owns a tile of ``TILE_Y`` lines ×
``TILE_X`` columns (32 threads of 4 columns across x) and a chunk of
``zchunk`` planes; :func:`plan` chooses the chunk and :func:`block_tiles`
mirrors the kernel's decoding of its 1-D block index.

The wrappers run the plain twin for CPU tensors only. For CUDA tensors they
launch the kernel or raise; nothing falls back. The output is always a fresh
tensor: every mode reads neighbouring rows of its inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sparse.formats import ConstDia, const_masks
from ..utils.device import sm_count

_MODES = {"spmv": 0, "residual": 1, "jacobi": 2, "zjr": 3, "cja": 4}
MAX_TAPS = 27        # kMaxTaps in csrc/const_stencil.cu
TILE_X = 128         # kTileX: columns per block, 4 per thread
TILE_Y = 4           # kTileY: lines per block
BLOCKS_PER_SM = 8    # the grid plan() aims for

launches = 0         # kernel launches by the wrappers (CUDA only)


def plan(dims, sms: int) -> tuple:
    """(tile_x, tile_y, zchunk, blocks) of the kernel's launch on ``dims =
    (nz, ny, nx)`` and a card of ``sms`` multiprocessors: the longest
    z-chunk (fewest halo planes) that still gives the grid about
    ``BLOCKS_PER_SM`` blocks per SM, as evenly split as ceil allows."""
    nz, ny, nx = dims
    tiles = -(-nx // TILE_X) * -(-ny // TILE_Y)
    chunks = max(1, min(nz, -(-BLOCKS_PER_SM * sms // max(tiles, 1))))
    zchunk = max(1, -(-nz // chunks))
    return TILE_X, TILE_Y, zchunk, tiles * -(-nz // zchunk)


def block_tiles(dims, zchunk: int, blocks) -> tuple:
    """(x0, y0, z0, planes) of each block in ``blocks`` (an integer array),
    decoded from the 1-D block index as the kernel decodes it: tile x
    fastest, then tile y, then the z-chunk. The block's threads (ty, tx)
    write rows (z0 + step, y0 + ty, x0 + 4·tx + j) for step < planes, ty <
    TILE_Y, tx < TILE_X / 4 and j < 4, where they lie inside the grid."""
    nz, ny, nx = dims
    tiles_x, tiles_y = -(-nx // TILE_X), -(-ny // TILE_Y)
    b = np.asarray(blocks, np.int64)
    z0 = b // (tiles_x * tiles_y) * zchunk
    return (b % tiles_x * TILE_X, b // tiles_x % tiles_y * TILE_Y, z0,
            np.minimum(zchunk, nz - z0))


def const_stencil_plain(a: ConstDia, x: torch.Tensor, mode: str = "spmv",
                        b=None, p=None, s=None) -> torch.Tensor:
    """Plain PyTorch twin of every kernel mode: the masked shift-and-add of
    the reference's ``spmv_const_xla`` (index-arithmetic masks, then
    ``where(mask, c_k, 0)·x_padded[…]`` summed in ascending k over the taps
    with c_k ≠ 0), then the mode's epilogue."""
    n = a.n_rows
    dev = x.device
    u = s * x + p if mode == "cja" else x
    y = torch.zeros(n, dtype=torch.float32, device=dev)
    if a.offsets:
        lo = max(0, -min(a.offsets))
        hi = max(0, max(a.offsets))
        up = torch.nn.functional.pad(u, (lo, hi))
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        masks = const_masks(a.taps, a.dims, dev)
        for off, c, m in zip(a.offsets, a.coeffs, masks):
            if c == 0.0:
                continue
            data_k = torch.where(
                m, torch.tensor(c, dtype=torch.float32, device=dev), zero)
            y = y + data_k * up[off + lo: off + lo + n]
    if mode == "residual":
        return b - y
    if mode == "jacobi":
        return x + s * (b - y)
    if mode == "zjr":
        return x - s * y
    if mode == "cja":
        return u + s * (x - y)
    return y


def _check(a: ConstDia, x, vecs, s, needs_s: bool):
    if not isinstance(a, ConstDia):
        raise TypeError(f"ConstDia operator expected, got {type(a).__name__}")
    if len(a.operand[1]) > MAX_TAPS:
        raise ValueError(f"{len(a.operand[1])} taps > kernel limit "
                         f"{MAX_TAPS}")
    n = a.n_rows
    for t in (x, *vecs):
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError(f"vectors must be float32 of shape ({n},), got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError("vectors on different devices")
        if not t.is_contiguous():
            raise ValueError("const_stencil operands must be contiguous")
    if x.device != a.device:
        raise ValueError(f"operator on {a.device}, vectors on {x.device}")
    if needs_s and not isinstance(s, float):
        raise TypeError("the Jacobi scale s must be a Python float")


def _apply(a: ConstDia, x: torch.Tensor, mode: str, b=None, p=None, s=None):
    vecs = tuple(v for v in (b, p) if v is not None)
    _check(a, x, vecs, s, mode in ("jacobi", "zjr", "cja"))
    if x.device.type == "cpu":
        return const_stencil_plain(a, x, mode, b, p, s)
    if x.device.type != "cuda":
        raise ValueError(f"no const_stencil kernel for device {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    from .._build import cuda_kernels

    lib = cuda_kernels()
    out = torch.empty(a.n_rows, dtype=torch.float32, device=x.device)
    taps, coeffs = a.operand
    nz, ny, nx = a.dims
    zchunk = plan(a.dims, sm_count(x.device.index))[2]
    rc = lib.const_stencil_launch(
        _MODES[mode], nz, ny, nx, zchunk, len(coeffs), taps.ctypes.data,
        coeffs.ctypes.data, 0.0 if s is None else s, x.data_ptr(),
        None if b is None else b.data_ptr(),
        None if p is None else p.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"const_stencil kernel launch failed: "
                           f"cudaError {rc}")
    global launches
    launches += 1
    return out


def spmv(a: ConstDia, x: torch.Tensor) -> torch.Tensor:
    """y = A·x."""
    return _apply(a, x, "spmv")


def residual(a: ConstDia, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """r = b − A·x in one pass."""
    return _apply(a, x, "residual", b=b)


def jacobi(a: ConstDia, x: torch.Tensor, b: torch.Tensor,
           s: float) -> torch.Tensor:
    """x' = x + s·(b − A·x) in one pass."""
    return _apply(a, x, "jacobi", b=b, s=s)


def presmooth_residual(a: ConstDia, b: torch.Tensor, s: float
                       ) -> torch.Tensor:
    """r = b − s·(A·b) in one pass: one Jacobi sweep from a zero guess
    (x₁ = s·b) and its residual b − A·x₁; s·b never materializes."""
    return _apply(a, b, "zjr", s=s)


def correct_jacobi(a: ConstDia, b: torch.Tensor, p: torch.Tensor,
                   s: float) -> torch.Tensor:
    """x' = u + s·(b − A·u), u = s·b + p, in one pass: the coarse-grid
    correction p of the pre-smoothed s·b, then one post-smoothing sweep."""
    return _apply(a, b, "cja", p=p, s=s)
