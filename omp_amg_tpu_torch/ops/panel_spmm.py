"""CSR × dense-panel SpMM: the hand-written CUDA kernel, its plain twin, the
wrapper and its launch counter.

Counterpart of ``omp_amg_tpu/ops/pallas_spmm.py``'s ``_spmm_kernel``
(entry ``spmm_panel``), ``_spmm_roll_kernel`` (``spmm_panel_roll``) and
``_spmm_v2_kernel`` (``spmm_panel_v2``); their XLA oracle is
``spmm_panel_xla``. The kernel is ``omp_amg_tpu_torch/csrc/panel_spmm.cu``:
U = A·X for an f32 ``Csr`` A and an f32 (n_cols, C) panel X, 1 ≤ C ≤ 128,
each row summed in CSR order with explicit rounding, so kernel and twin give
the same bits (up to the sign of a zero). :func:`lane_plan` picks the
kernel's instance from C: vector lanes of four columns where 32 divides C
(every probe panel), else a warp per row.

Not ported, because they size and schedule TPU VMEM windows: ``split_bf16``,
``vmem_fit``, ``roll_ring_chunks``, ``PanelPlanV2``, ``schedule_plan_v2``,
``build_plan_v2`` and ``sparse/panels.py``. On the GPU, X is gathered row by
row from device memory through the caches.

The wrapper runs the plain twin for CPU tensors only. For CUDA tensors it
launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import torch

from ..sparse.formats import Csr

MAX_COLS = 128       # kMaxCols in csrc/panel_spmm.cu
WARP = 32

launches = 0         # kernel launches by the wrapper (CUDA only)


def spmm_panel_plain(a: Csr, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: the CSR rows walked as padded slots in CSR order,
    ``u = u + v[:, k, None] * x[col[:, k]]`` for k up to the widest row
    (padding has v = 0, col = 0). Temporaries stay (n_rows, C); eager ops
    round the product and the sum separately, as the kernel does."""
    n, c = a.n_rows, x.shape[1]
    u = torch.zeros((n, c), dtype=torch.float32, device=x.device)
    if a.nnz == 0 or n == 0:
        return u
    start = a.indptr[:-1]
    length = a.indptr[1:] - start
    for k in range(int(length.max())):
        live = length > k
        pos = torch.where(live, start + k, 0)
        v = torch.where(live, a.vals[pos], 0.0)
        col = torch.where(live, a.indices[pos], 0).long()
        u = u + v[:, None] * x[col]
    return u


def lane_plan(c: int) -> tuple:
    """(q, group, rows_per_warp) of the kernel instance for a panel of ``c``
    columns. Where 32 divides c, q = c / 32 and a lane owns four consecutive
    columns (one 16-byte load per nonzero): a row takes 8q lanes of a group
    of ``group`` lanes, and ``rows_per_warp`` groups share a warp. Else
    q = 0: a warp per row, lane l owning columns l, l + 32, l + 64, l + 96
    below c."""
    if c % WARP == 0:
        q = c // WARP
        group = {1: 8, 2: 16}.get(q, WARP)
        return q, group, WARP // group
    return 0, WARP, 1


def lane_columns(c: int) -> list:
    """The columns each lane of a row's group owns under :func:`lane_plan`
    (the kernel's mapping, for the tests)."""
    q, group, _ = lane_plan(c)
    if q:
        return [list(range(4 * g, 4 * g + 4)) if g < 8 * q else []
                for g in range(group)]
    return [list(range(g, c, WARP)) for g in range(group)]


def _check(a: Csr, x: torch.Tensor):
    if a.vals.dtype != torch.float32:
        raise TypeError(f"panel SpMM values must be float32, got "
                        f"{a.vals.dtype}")
    if a.indptr.dtype != torch.int64 or a.indices.dtype != torch.int32:
        raise TypeError("CSR indptr must be int64 and indices int32")
    if a.vals.shape != a.indices.shape:
        raise ValueError("CSR values and indices differ in length")
    if (x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != a.n_cols
            or not 1 <= x.shape[1] <= MAX_COLS):
        raise ValueError(f"x must be float32 of shape ({a.n_cols}, C) with "
                         f"1 ≤ C ≤ {MAX_COLS}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    for t in (a.indptr, a.indices, a.vals, x):
        if t.device != x.device:
            raise ValueError("operator and panel on different devices")
        if not t.is_contiguous():
            raise ValueError("panel SpMM operands must be contiguous")


def spmm_panel(a: Csr, x: torch.Tensor) -> torch.Tensor:
    """U = A·X: (n_rows, C) f32, a fresh tensor."""
    _check(a, x)
    if x.device.type == "cpu":
        return spmm_panel_plain(a, x)
    if x.device.type != "cuda":
        raise ValueError(f"no panel SpMM kernel for device {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    from .._build import cuda_kernels

    lib = cuda_kernels()
    out = torch.empty((a.n_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    q = lane_plan(x.shape[1])[0]
    if x.data_ptr() % 16:    # a view off a 16-byte boundary: 4-byte loads
        q = 0
    rc = lib.panel_spmm_launch(
        a.n_rows, x.shape[1], q, a.indptr.data_ptr(),
        a.indices.data_ptr(), a.vals.data_ptr(), x.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"panel_spmm kernel launch failed: cudaError {rc}")
    global launches
    launches += 1
    return out
