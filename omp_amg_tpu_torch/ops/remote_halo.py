"""Plane-halo exchange between shards: the hand-written CUDA kernel, its
plain twin, the wrapper and its launch counter.

Counterpart of ``omp_amg_tpu/parallel/slab.py::_remote_halo_kernel`` (the
"pallas" halo transport of ``_exchange_planes_remote``). The kernel is
``omp_amg_tpu_torch/csrc/remote_halo.cu``: one launch copies, for every
shard i of d, its last ``nl`` rows into the left halo of shard (i + 1) % d
and its first ``nr`` rows into the right halo of shard (i − 1) % d. The
exchange is circular, like the TPU kernel's; the caller masks the global
ends. The copy is exact.

All shards must lie on the current CUDA device; shards on different cards
need peer access between them, which is not implemented. The wrapper runs
the plain twin for CPU tensors only. For CUDA tensors it launches the kernel
or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

MAX_SHARDS = 64      # kMaxShards in csrc/remote_halo.cu

launches = 0         # kernel launches by the wrapper (CUDA only)


def remote_halo_plain(srcs, nl: int, nr: int):
    """Plain PyTorch twin (circular slicing): ``(left, right)``, lists of d
    fresh tensors of nl and nr rows; left[i] is shard (i − 1) % d's last nl
    rows, right[i] shard (i + 1) % d's first nr rows."""
    d = len(srcs)
    left = [srcs[(i - 1) % d][srcs[0].numel() - nl:].clone()
            for i in range(d)]
    right = [srcs[(i + 1) % d][:nr].clone() for i in range(d)]
    return left, right


def _check(srcs, nl: int, nr: int):
    if not 1 <= len(srcs) <= MAX_SHARDS:
        raise ValueError(f"{len(srcs)} shards: the kernel takes 1 to "
                         f"{MAX_SHARDS}")
    n = srcs[0].numel()
    for t in srcs:
        if t.dtype != torch.float32 or t.dim() != 1 or t.numel() != n:
            raise ValueError(f"shards must be float32 vectors of one length "
                             f"({n}), got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("remote_halo shards must be contiguous")
    if not (0 <= nl <= n and 0 <= nr <= n):
        raise ValueError(f"halo widths ({nl}, {nr}) outside [0, {n}]")
    if len({t.device for t in srcs}) > 1:
        raise NotImplementedError(
            "shards on different devices: the exchange between cards needs "
            "peer access, which is not implemented yet")


def remote_halo(srcs, nl: int, nr: int):
    """``(left, right)`` halo strips of every shard (see
    :func:`remote_halo_plain`), fresh tensors, circular."""
    srcs = list(srcs)
    _check(srcs, nl, nr)
    dev = srcs[0].device
    if dev.type == "cpu":
        return remote_halo_plain(srcs, nl, nr)
    if dev.type != "cuda":
        raise ValueError(f"no remote_halo kernel for device {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"shards on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    d = len(srcs)
    left = torch.empty((d, nl), dtype=torch.float32, device=dev)
    right = torch.empty((d, nr), dtype=torch.float32, device=dev)
    if nl or nr:
        from .._build import cuda_kernels

        lib = cuda_kernels()
        table = ctypes.c_void_p * d
        lp, rp = left.data_ptr(), right.data_ptr()   # row i at + 4·width·i
        rc = lib.remote_halo_launch(
            d, srcs[0].numel(), nl, nr,
            table(*(t.data_ptr() for t in srcs)),
            table(*(lp + 4 * nl * i for i in range(d))),
            table(*(rp + 4 * nr * i for i in range(d))),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"remote_halo kernel launch failed: "
                               f"cudaError {rc}")
        global launches
        launches += 1
    return list(left.unbind(0)), list(right.unbind(0))
