"""Tiled-CSR SpMV: the hand-written CUDA kernel, its plain twin, the wrapper
and its launch counter.

The kernel is ``omp_amg_tpu_torch/csrc/tile_csr.cu``; it replaces no TPU
kernel, but serves the long-row operators of the PMIS hierarchy that
:func:`~omp_amg_tpu_torch.sparse.formats.tile_rule` gives the tiled form
(:class:`~omp_amg_tpu_torch.sparse.formats.TileCsr`), with the four modes of
:mod:`.csr_spmv`: spmv ``A·x``, residual ``b − A·x``, correct ``v + A·x``,
jacobi ``x + s ⊙ (b − A·x)``. One block per tile holds the tile's x window
in shared memory; its warps stream the 16-bit indices and the values.
Every output is bitwise the CSR kernel's for the same operator: the same
lanes per row (``a.vec``), the same order of every sum.

The plain twin decodes the global columns and runs the CSR twin, so it is
bitwise :func:`.csr_spmv.csr_spmv_plain`. The wrappers run it for CPU
tensors only. For CUDA tensors they launch the kernel or raise; nothing
falls back.
"""

from __future__ import annotations

import torch

from ..sparse.formats import TileCsr, tile_to_csr
from .csr_spmv import csr_spmv_plain

_MODES = {"spmv": 0, "residual": 1, "correct": 2, "jacobi": 3}
_VECS = (8, 16, 32)

launches = 0         # kernel launches by the wrappers (CUDA only)


def tile_csr_plain(a: TileCsr, x: torch.Tensor, mode: str = "spmv", v=None,
                   b=None, s=None) -> torch.Tensor:
    """Plain PyTorch twin of every kernel mode: the CSR twin on the decoded
    global columns."""
    return csr_spmv_plain(tile_to_csr(a), x, mode, v, b, s)


def _check(a: TileCsr, x, rowvecs):
    if a.vals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tiled CSR values must be float32 or bfloat16, got "
                        f"{a.vals.dtype}")
    tables = (a.indptr, a.tile_rows, a.tile_ptr)
    if a.indices.dtype != torch.int16 or a.tile_cols.dtype != torch.int32 \
            or any(t.dtype != torch.int64 for t in tables):
        raise TypeError("tiled CSR: indices int16, tile_cols int32, indptr "
                        "and the tile tables int64")
    if a.vals.shape != a.indices.shape:
        raise ValueError("tiled CSR values and indices differ in length")
    if a.vec not in _VECS:
        raise ValueError(f"the tiled kernel serves rows of {_VECS} lanes, "
                         f"not {a.vec}")
    if x.dtype != torch.float32 or x.shape != (a.n_cols,):
        raise ValueError(f"x must be float32 of shape ({a.n_cols},), got "
                         f"{x.dtype} {tuple(x.shape)}")
    for t in rowvecs:
        if t.dtype != torch.float32 or t.shape != (a.n_rows,):
            raise ValueError(f"row vectors must be float32 of shape "
                             f"({a.n_rows},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (*tables, a.indices, a.vals, a.tile_cols, x, *rowvecs):
        if t.device != x.device:
            raise ValueError("operator and vectors on different devices")
        if not t.is_contiguous():
            raise ValueError("tiled CSR kernel operands must be contiguous")


def _apply(a: TileCsr, x: torch.Tensor, mode: str, v=None, b=None, s=None):
    if mode == "jacobi" and a.n_cols != a.n_rows:
        raise ValueError("jacobi needs a square operator")
    _check(a, x, tuple(t for t in (v, b, s) if t is not None))
    if x.device.type == "cpu":
        return tile_csr_plain(a, x, mode, v, b, s)
    if x.device.type != "cuda":
        raise ValueError(f"no tiled CSR kernel for device {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    from .._build import cuda_kernels

    lib = cuda_kernels()
    out = torch.empty(a.n_rows, dtype=torch.float32, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.tile_csr_launch(
        _MODES[mode], int(a.vals.dtype == torch.bfloat16), a.vec, a.n_tiles,
        a.window, *(t.data_ptr() for t in (
            a.tile_rows, a.tile_ptr, a.tile_cols, a.indptr, a.indices,
            a.vals, x)),
        ptr(v), ptr(b), ptr(s), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tile_csr kernel launch failed: cudaError {rc}")
    global launches
    launches += 1
    return out


def spmv(a: TileCsr, x: torch.Tensor) -> torch.Tensor:
    """y = A·x."""
    return _apply(a, x, "spmv")


def residual(a: TileCsr, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """r = b − A·x in one pass."""
    return _apply(a, x, "residual", b=b)


def correct(p: TileCsr, xc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x + P·xc in one pass."""
    return _apply(p, xc, "correct", v=x)


def jacobi(a: TileCsr, x: torch.Tensor, b: torch.Tensor,
           s: torch.Tensor) -> torch.Tensor:
    """x' = x + s ⊙ (b − A·x) in one pass (s = ω·D⁻¹); a fresh tensor."""
    return _apply(a, x, "jacobi", b=b, s=s)
