"""Row-wise gather out[i, s] = w[i, idx[i, s]]: the hand-written CUDA kernel,
its plain twin, the wrapper and its launch counter.

Counterpart of ``omp_amg_tpu/ops/pallas_spmm.py::_extract_kernel`` (entry
``extract_lanes``), which pulls the Galerkin entries out of the probe
products of the colored-probing RAP. The kernel is
``omp_amg_tpu_torch/csrc/extract_lanes.cu``. The TPU kernel takes a
128-lane ``w`` and 128-multiple shapes; this one takes any (R, W) ``w`` and
(R, S) ``idx``. The copy is exact. An index outside [0, W) raises on the
CPU (``torch.gather``) and traps in the kernel, which fails the CUDA
context: the caller guarantees the range.

The wrapper runs the plain twin for CPU tensors only. For CUDA tensors it
launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import torch

launches = 0         # kernel launches by the wrapper (CUDA only)


def extract_lanes_plain(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: ``torch.gather`` along the rows."""
    return torch.gather(w, 1, idx.long())


def _check(w: torch.Tensor, idx: torch.Tensor):
    if w.dtype != torch.float32 or w.dim() != 2:
        raise ValueError(f"w must be a float32 matrix, got {w.dtype} "
                         f"{tuple(w.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[0] != \
            w.shape[0]:
        raise ValueError(f"idx must be int32 of shape ({w.shape[0]}, S), got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if idx.device != w.device:
        raise ValueError("w and idx on different devices")
    if not (w.is_contiguous() and idx.is_contiguous()):
        raise ValueError("extract_lanes operands must be contiguous")


def extract_lanes(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, s] = w[i, idx[i, s]]: (R, S) f32, a fresh tensor."""
    _check(w, idx)
    if w.device.type == "cpu":
        return extract_lanes_plain(w, idx)
    if w.device.type != "cuda":
        raise ValueError(f"no extract_lanes kernel for device {w.device}")
    if w.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {w.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    from .._build import cuda_kernels

    lib = cuda_kernels()
    out = torch.empty(idx.shape, dtype=torch.float32, device=w.device)
    rc = lib.extract_lanes_launch(
        idx.shape[0], idx.shape[1], w.shape[1], w.data_ptr(), idx.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(w.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"extract_lanes kernel launch failed: "
                           f"cudaError {rc}")
    global launches
    launches += 1
    return out
