"""CSR SpMV: the hand-written CUDA kernel, its plain twin, the wrapper and
its launch counter.

Counterpart of ``omp_amg_tpu/ops/pallas_routed.py::_kloop_kernel`` (entry
points ``spmv_routed``, ``residual_routed``, ``correct_routed`` and
``jacobi_routed``); the kernel is ``omp_amg_tpu_torch/csrc/csr_spmv.cu``.
Modes: spmv ``A·x``, residual ``b − A·x``, correct ``v + A·x`` (the coarse
grid correction x + P·xc), jacobi ``x + s ⊙ (b − A·x)``. Values are f32 or
bf16; vectors and results are f32; rows sum in f32.

The kernel gives each row ``a.vec`` lanes (1 to 32, a power of two: the
host rule :attr:`Csr.vec` on the operator's mean row length), so a warp
serves 32 / ``a.vec`` rows. The wrapper always passes that width; only a
test forces another, through the C entry point's ``vec`` argument.

The wrappers run the plain twin for CPU tensors only. For CUDA tensors they
launch the kernel or raise; nothing falls back.
"""

from __future__ import annotations

import torch

from ..sparse.formats import Csr

_MODES = {"spmv": 0, "residual": 1, "correct": 2, "jacobi": 3}

launches = 0         # kernel launches by the wrappers (CUDA only)


def csr_spmv_plain(a: Csr, x: torch.Tensor, mode: str = "spmv", v=None,
                   b=None, s=None) -> torch.Tensor:
    """Plain PyTorch twin of every kernel mode: products gathered per
    nonzero, then ``index_add_`` over the row ids, then the epilogue."""
    n = a.n_rows
    rows = torch.repeat_interleave(
        torch.arange(n, device=x.device), a.indptr.diff(),
        output_size=a.nnz)
    prod = a.vals.float() * x[a.indices.long()]
    y = torch.zeros(n, dtype=torch.float32, device=x.device).index_add_(
        0, rows, prod)
    if mode == "residual":
        return b - y
    if mode == "correct":
        return v + y
    if mode == "jacobi":
        return x + s * (b - y)
    return y


def _check(a: Csr, x, rowvecs):
    if a.vals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"CSR values must be float32 or bfloat16, got "
                        f"{a.vals.dtype}")
    if a.indptr.dtype != torch.int64 or a.indices.dtype != torch.int32:
        raise TypeError("CSR indptr must be int64 and indices int32")
    if a.vals.shape != a.indices.shape:
        raise ValueError("CSR values and indices differ in length")
    if x.dtype != torch.float32 or x.shape != (a.n_cols,):
        raise ValueError(f"x must be float32 of shape ({a.n_cols},), got "
                         f"{x.dtype} {tuple(x.shape)}")
    for t in rowvecs:
        if t.dtype != torch.float32 or t.shape != (a.n_rows,):
            raise ValueError(f"row vectors must be float32 of shape "
                             f"({a.n_rows},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (a.indptr, a.indices, a.vals, x, *rowvecs):
        if t.device != x.device:
            raise ValueError("operator and vectors on different devices")
        if not t.is_contiguous():
            raise ValueError("CSR kernel operands must be contiguous")


def _apply(a: Csr, x: torch.Tensor, mode: str, v=None, b=None, s=None):
    if mode == "jacobi" and a.n_rows != a.n_cols:
        raise ValueError("jacobi needs a square operator")
    _check(a, x, tuple(t for t in (v, b, s) if t is not None))
    if x.device.type == "cpu":
        return csr_spmv_plain(a, x, mode, v, b, s)
    if x.device.type != "cuda":
        raise ValueError(f"no CSR kernel for device {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    from .._build import cuda_kernels

    lib = cuda_kernels()
    out = torch.empty(a.n_rows, dtype=torch.float32, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.csr_spmv_launch(
        _MODES[mode], int(a.vals.dtype == torch.bfloat16), a.vec, a.n_rows,
        a.indptr.data_ptr(), a.indices.data_ptr(), a.vals.data_ptr(),
        x.data_ptr(), ptr(v), ptr(b), ptr(s), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"csr_spmv kernel launch failed: cudaError {rc}")
    global launches
    launches += 1
    return out


def spmv(a: Csr, x: torch.Tensor) -> torch.Tensor:
    """y = A·x."""
    return _apply(a, x, "spmv")


def residual(a: Csr, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """r = b − A·x in one pass."""
    return _apply(a, x, "residual", b=b)


def correct(p: Csr, xc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x + P·xc in one pass (the coarse-grid correction)."""
    return _apply(p, xc, "correct", v=x)


def jacobi(a: Csr, x: torch.Tensor, b: torch.Tensor,
           s: torch.Tensor) -> torch.Tensor:
    """x' = x + s ⊙ (b − A·x) in one pass (s = ω·D⁻¹); a fresh tensor."""
    return _apply(a, x, "jacobi", b=b, s=s)
