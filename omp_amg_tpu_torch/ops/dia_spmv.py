"""Banded (DIA) SpMV: the hand-written CUDA kernel, its plain twin, the
wrapper and its launch counter.

Counterpart of two TPU kernels of ``omp_amg_tpu/ops/pallas_spmv.py``:
``_plane_kernel`` (entry points ``spmv_plane_dia``, ``residual_plane_dia``,
``jacobi_plane_dia`` and ``spmv_dia_planes``: 3D operators with the plane
layout) and ``_dia_kernel`` (``spmv_dia_pallas``: banded operators without
it, such as 2D grids, of at least three row blocks). Both compute the same
banded product; they differ only in TPU memory layout, so one kernel,
``omp_amg_tpu_torch/csrc/dia_spmv.cu``, serves any offsets. Modes: spmv
``A·x``, residual ``b − A·x``, jacobi ``x + s ⊙ (b − A·x)``. Values are f32
or bf16; vectors and results are f32.

The kernel has two instantiations. The vector path computes R consecutive
rows per thread (R = 8 for bf16 values, 4 for f32) with 16-byte loads; it
needs ``n % R == 0``, ``x_base % R == 0`` and 16-byte-aligned operands, and
it is taken where its n / R threads still fill the card (at least
``VECTOR_MIN_THREADS_PER_SM`` per SM: :func:`vector_path`). The scalar path,
a thread per row, takes everything else: on a smaller operator four or
eight times the threads hide more latency than the wide loads save. Neither
is a fallback for the other: the wrapper picks one from the shapes before
the launch. ``launches`` counts every launch, ``scalar_launches`` those
that took the scalar path.

``x`` may be a window longer than the operator's n rows: with ``x_base``,
row i's tap reads ``x[x_base + i + off]`` where that index lies in the
window (zero outside it). A z-slab shard of the distributed path
(:mod:`omp_amg_tpu_torch.parallel.slab`) reads its exchanged window this
way, one launch per shard-local product; ``x_base = 0`` over an n-row x is
the single-device product.

The wrappers run the plain twin for CPU tensors only. For CUDA tensors they
launch the kernel or raise; nothing falls back.
"""

from __future__ import annotations

import torch

from ..sparse.formats import Dia
from ..utils.device import sm_count

_MODES = {"spmv": 0, "residual": 1, "jacobi": 2}
MAX_DIAG = 64        # kMaxDiag in csrc/dia_spmv.cu
VECTOR_MIN_THREADS_PER_SM = 512    # a quarter of an SM's resident threads

launches = 0         # kernel launches by the wrappers (CUDA only)
scalar_launches = 0  # of those, launches of the scalar path


def dia_spmv_plain(a: Dia, x: torch.Tensor, mode: str = "spmv", b=None,
                   s=None, x_base: int = 0) -> torch.Tensor:
    """Plain PyTorch twin of every kernel mode: taps summed in ascending k
    over a zero-padded x, as the reference's ``spmv_dia`` does."""
    n = a.n_rows
    y = torch.zeros(n, dtype=torch.float32, device=x.device)
    if a.offsets:
        lo = max(0, -(x_base + min(a.offsets)))
        hi = max(0, x_base + n + max(a.offsets) - x.numel())
        xp = torch.nn.functional.pad(x, (lo, hi))
        for k, off in enumerate(a.offsets):
            start = x_base + off + lo
            y = y + a.data[k].float() * xp[start: start + n]
    if mode == "residual":
        return b - y
    if mode == "jacobi":
        return x[x_base: x_base + n] + s * (b - y)
    return y


def _check(a: Dia, x, vecs, x_base: int):
    if not isinstance(a.data, torch.Tensor):
        raise TypeError("device DIA operator expected (torch data); use "
                        "sparse.formats.dia_to_device")
    n = a.n_rows
    if a.data.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"DIA values must be float32 or bfloat16, got "
                        f"{a.data.dtype}")
    if a.data.dim() != 2 or a.data.shape[0] != len(a.offsets):
        raise ValueError("DIA data must be (ndiag, n)")
    if len(a.offsets) > MAX_DIAG:
        raise ValueError(f"{len(a.offsets)} diagonals > kernel limit "
                         f"{MAX_DIAG}")
    if any(abs(o) >= 2 ** 31 for o in a.offsets):
        raise ValueError("DIA offsets must fit in int32")
    for t in vecs:
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError(f"vectors must be float32 of shape ({n},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError(f"x must be a float32 vector, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not 0 <= x_base <= x.numel() - n:
        raise ValueError(f"the window x[{x_base}:{x_base + n}] of the "
                         f"{n} rows lies outside x ({x.numel()} values)")
    for t in (a.data, x, *vecs):
        if t.device != x.device:
            raise ValueError("operator and vectors on different devices")
        if not t.is_contiguous():
            raise ValueError("DIA kernel operands must be contiguous")


def vector_path(a: Dia, x: torch.Tensor, x_base: int, vecs, sms: int) -> bool:
    """True when the product takes the kernel's vector path on a card of
    ``sms`` multiprocessors: R = 16 bytes of values per thread divides n and
    ``x_base``; ``a.data``, ``x`` and the row vectors ``vecs`` start on
    16-byte boundaries (the output is a fresh allocation, which always
    does); and the n / R threads number at least
    ``VECTOR_MIN_THREADS_PER_SM`` per SM."""
    rows = 16 // a.data.element_size()
    n = a.n_rows
    if (n % rows or x_base % rows
            or n // rows < sms * VECTOR_MIN_THREADS_PER_SM):
        return False
    return not (a.data.data_ptr() % 16 or x.data_ptr() % 16
                or any(t.data_ptr() % 16 for t in vecs))


def _apply(a: Dia, x: torch.Tensor, mode: str, b=None, s=None,
           x_base: int = 0):
    vecs = tuple(v for v in (b, s) if v is not None)
    _check(a, x, vecs, x_base)
    if x.device.type == "cpu":
        return dia_spmv_plain(a, x, mode, b, s, x_base)
    if x.device.type != "cuda":
        raise ValueError(f"no DIA kernel for device {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    from .._build import cuda_kernels

    lib = cuda_kernels()
    out = torch.empty(a.n_rows, dtype=torch.float32, device=x.device)
    vec = vector_path(a, x, x_base, vecs, sm_count(x.device.index))
    rc = lib.dia_spmv_launch(
        _MODES[mode], int(a.data.dtype == torch.bfloat16), int(vec),
        a.n_rows, len(a.offsets), a.offsets_i32,
        a.data.data_ptr(), x.data_ptr(), x_base, x.numel(),
        None if b is None else b.data_ptr(),
        None if s is None else s.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dia_spmv kernel launch failed: cudaError {rc}")
    global launches, scalar_launches
    launches += 1
    scalar_launches += not vec
    return out


def spmv(a: Dia, x: torch.Tensor, x_base: int = 0) -> torch.Tensor:
    """y = A·x (x: the n rows, or a window holding them at ``x_base``)."""
    return _apply(a, x, "spmv", x_base=x_base)


def residual(a: Dia, x: torch.Tensor, b: torch.Tensor,
             x_base: int = 0) -> torch.Tensor:
    """r = b − A·x in one pass."""
    return _apply(a, x, "residual", b=b, x_base=x_base)


def jacobi(a: Dia, x: torch.Tensor, b: torch.Tensor, s: torch.Tensor,
           x_base: int = 0) -> torch.Tensor:
    """x' = x + s ⊙ (b − A·x) in one pass (s = ω·D⁻¹); a fresh tensor of
    the n rows."""
    return _apply(a, x, "jacobi", b=b, s=s, x_base=x_base)
