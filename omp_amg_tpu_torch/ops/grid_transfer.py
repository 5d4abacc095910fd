"""Structured grid transfers: the hand-written CUDA kernel, its plain twin,
the wrappers and their launch counter.

The kernel is ``omp_amg_tpu_torch/csrc/grid_transfer.cu``. It replaces no
TPU kernel: the reference computes the transfers outside Pallas (per-axis
MXU matmuls on the TPU), and the port's per-axis torch slices, which set the
pace of the structured V-cycle on the card, stay as the plain twin
(:func:`..amg.structured.apply_restrict`, :func:`..amg.structured.
apply_prolong`). One launch covers every coarsened axis of a grid of up to
three axes (any subset coarsened, odd or even fine extents), f32 or f64,
bit for bit the twin's result:

- :func:`restrict` ``R·xf``; :func:`prolong` ``P·xc``;
- :func:`correct` ``x + P·xc``: the coarse-grid correction in one pass.

A thread writes ``WIDTH`` consecutive outputs along x of one line; a block
of ``lanes`` × ``rows`` threads marches along z through ``zchunk`` output
planes. :func:`plan` decides the whole launch (the kernel only decodes its
1-D block index from the plan's tiles) and :func:`block_tiles` mirrors that
decoding.

The wrappers run the plain twin for CPU tensors only. For CUDA tensors they
launch the kernel or raise (also for a grid of more than three axes);
nothing falls back. The output is always a fresh tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..amg.structured import (
    GridProlong, GridRestrict, apply_prolong, apply_restrict,
)
from ..utils.device import sm_count

THREADS = 256        # kThreads: threads per block, at most
WIDTH = 4            # kWidth: outputs per thread along x
BLOCKS_PER_SM = 8    # the grid plan() aims for
MAX_AXES = 3

launches = 0         # kernel launches by the wrappers (CUDA only)


def _pow2(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def dims3(shape) -> tuple:
    """A grid of up to three axes as (nz, ny, nx): leading extents of 1."""
    return (1,) * (MAX_AXES - len(shape)) + tuple(int(n) for n in shape)


class Plan(NamedTuple):
    """The kernel's launch: ``blocks`` blocks of ``lanes`` × ``rows``
    threads, the output's lines cut into ``tiles_x`` × ``tiles_y`` tiles,
    each block marching through ``zchunk`` output planes."""
    lanes: int
    rows: int
    zchunk: int
    tiles_x: int
    tiles_y: int
    blocks: int


def plan(out_dims, sms: int) -> Plan:
    """The launch writing the output grid ``out_dims = (nz, ny, nx)`` on a
    card of ``sms`` multiprocessors: ``lanes`` threads along x (a power of
    two up to 32, enough for the line's groups of ``WIDTH``), ``rows``
    lines (a power of two, up to ``THREADS`` threads a block), and the
    longest z-chunk that still gives the grid about ``BLOCKS_PER_SM``
    blocks per SM."""
    nz, ny, nx = out_dims
    groups = -(-nx // WIDTH)
    lanes = min(32, _pow2(groups))
    rows = min(THREADS // lanes, _pow2(ny))
    tiles_x, tiles_y = -(-groups // lanes), -(-ny // rows)
    chunks = max(1, min(nz, -(-BLOCKS_PER_SM * sms // (tiles_x * tiles_y))))
    zchunk = -(-nz // chunks)
    return Plan(lanes, rows, zchunk, tiles_x, tiles_y,
                tiles_x * tiles_y * -(-nz // zchunk))


def block_tiles(out_dims, pl: Plan, blocks) -> tuple:
    """(x0, y0, z0, planes) of each block in ``blocks`` (an integer array),
    decoded from the 1-D block index as the kernel decodes it: tile x
    fastest, then tile y, then the z-chunk. The block's thread t = ty·lanes
    + tx writes outputs (z0 + step, y0 + ty, x0 + WIDTH·tx + j) for step <
    planes and j < WIDTH, where they lie inside the grid."""
    b = np.asarray(blocks, np.int64)
    z0 = b // (pl.tiles_x * pl.tiles_y) * pl.zchunk
    return (b % pl.tiles_x * pl.lanes * WIDTH,
            b // pl.tiles_x % pl.tiles_y * pl.rows, z0,
            np.minimum(pl.zchunk, out_dims[0] - z0))


def _check(op, cls, v: torch.Tensor, x=None):
    """Raise unless ``op`` is a ``cls`` with extents that fit, ``v`` its
    input and ``x`` (if given) its output's shape, f32 or f64, contiguous
    and on one device."""
    if not isinstance(op, cls):
        raise TypeError(f"{cls.__name__} expected, got {type(op).__name__}")
    if not (len(op.fine_shape) == len(op.coarse_shape) == len(op.coarsened)):
        raise ValueError("fine_shape, coarse_shape and coarsened differ in "
                         "length")
    for nf, nc, c in zip(op.fine_shape, op.coarse_shape, op.coarsened):
        if nc < 1 or (nf not in (2 * nc - 1, 2 * nc) if c else nf != nc):
            raise ValueError(f"extents {nf} (fine) and {nc} (coarse) do not "
                             f"fit an axis {'' if c else 'not '}coarsened")
    if v.dtype not in (torch.float32, torch.float64) or \
            v.shape != (op.n_cols,):
        raise ValueError(f"input must be float32 or float64 of shape "
                         f"({op.n_cols},), got {v.dtype} {tuple(v.shape)}")
    if x is not None:
        if x.dtype != v.dtype or x.shape != (op.n_rows,):
            raise ValueError(f"x must be {v.dtype} of shape ({op.n_rows},), "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.device != v.device:
            raise ValueError("vectors on different devices")
    if not (v.is_contiguous() and (x is None or x.is_contiguous())):
        raise ValueError("grid_transfer operands must be contiguous")


def _launch(op, v: torch.Tensor, x=None) -> torch.Tensor:
    """The kernel on CUDA tensors: restriction for a ``GridRestrict``,
    prolongation (with x: x + P·v) for a ``GridProlong``."""
    if v.device.type != "cuda":
        raise ValueError(f"no grid_transfer kernel for device {v.device}")
    if v.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {v.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if len(op.fine_shape) > MAX_AXES:
        raise ValueError(f"the grid_transfer kernel takes up to {MAX_AXES} "
                         f"axes, got {len(op.fine_shape)}")
    from .._build import cuda_kernels

    lib = cuda_kernels()
    kind = int(isinstance(op, GridProlong))
    fine, coarse = dims3(op.fine_shape), dims3(op.coarse_shape)
    flags = (False,) * (MAX_AXES - len(op.coarsened)) + tuple(op.coarsened)
    mask = sum(1 << k for k, c in enumerate(flags) if c)
    out_dims = fine if kind else coarse
    pl = plan(out_dims, sm_count(v.device.index))
    out = torch.empty(int(np.prod(out_dims)), dtype=v.dtype, device=v.device)
    rc = lib.grid_transfer_launch(
        kind, int(v.dtype == torch.float64), *fine, *coarse, mask, *pl,
        v.data_ptr(), None if x is None else x.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(v.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grid_transfer kernel launch failed: "
                           f"cudaError {rc}")
    global launches
    launches += 1
    return out


def restrict(r: GridRestrict, xf: torch.Tensor) -> torch.Tensor:
    """xc = R·xf (R = Pᵀ)."""
    _check(r, GridRestrict, xf)
    if xf.device.type == "cpu":
        return apply_restrict(r, xf)
    return _launch(r, xf)


def prolong(p: GridProlong, xc: torch.Tensor) -> torch.Tensor:
    """x = P·xc."""
    _check(p, GridProlong, xc)
    if xc.device.type == "cpu":
        return apply_prolong(p, xc)
    return _launch(p, xc)


def correct(p: GridProlong, xc: torch.Tensor, x: torch.Tensor
            ) -> torch.Tensor:
    """x + P·xc in one pass (the coarse-grid correction)."""
    _check(p, GridProlong, xc, x)
    if xc.device.type == "cpu":
        return x + apply_prolong(p, xc)
    return _launch(p, xc, x)
