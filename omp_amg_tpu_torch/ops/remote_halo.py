"""Halo-window exchange between shards: the hand-written CUDA kernel, its
plain twin, the wrapper and its launch counters.

Counterpart of ``omp_amg_tpu/parallel/slab.py::_remote_halo_kernel`` (the
"pallas" halo transport) together with what the reference's
``_exchange_planes_remote`` does with its strips: the zero mask at the
global ends and the concatenation into each shard's x window. The kernel is
``omp_amg_tpu_torch/csrc/remote_halo.cu``: one launch writes, for every
shard i of d, its window

    [shard i − 1's last nl rows | shard i's n rows | shard i + 1's first nr rows]

with zeros in place of the missing neighbour at the two global ends
(non-circular, the Dirichlet invariant), as the rows of one ``(d, nl + n +
nr)`` tensor. The copy is exact.

The kernel has two instantiations. The vector path moves 16 bytes per
thread; it needs n, nl and nr to be multiples of 4 and every shard to start
on a 16-byte boundary (:func:`vector_path`; the output is a fresh
allocation, whose rows then do too). The scalar path, a float per thread,
takes everything else. ``launches`` counts every launch, ``scalar_launches``
those that took the scalar path.

All shards must lie on the current CUDA device; shards on different cards
need peer access between them, which is not implemented. The wrapper runs
the plain twin for CPU tensors only. For CUDA tensors it launches the kernel
or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

MAX_SHARDS = 64      # kMaxShards in csrc/remote_halo.cu
_Table = ctypes.c_void_p * MAX_SHARDS   # the kernel's source pointer table

launches = 0         # kernel launches by the wrapper (CUDA only)
scalar_launches = 0  # of those, launches of the scalar path


def remote_halo_window_plain(srcs, nl: int, nr: int) -> torch.Tensor:
    """Plain PyTorch twin: the ``(d, nl + n + nr)`` windows by slicing,
    ``new_zeros`` at the global ends and one ``torch.cat``."""
    d, n = len(srcs), srcs[0].numel()
    parts = []
    for i, x in enumerate(srcs):
        parts += [srcs[i - 1][n - nl:] if i > 0 else x.new_zeros(nl), x,
                  srcs[i + 1][:nr] if i < d - 1 else x.new_zeros(nr)]
    return torch.cat(parts).view(d, nl + n + nr)


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


def vector_path(srcs, n: int, nl: int, nr: int) -> bool:
    """True when the exchange takes the kernel's vector path: 4 floats (16
    bytes) divide n, nl and nr, and every shard starts on a 16-byte
    boundary."""
    if n % 4 or nl % 4 or nr % 4:
        return False
    return not any(t.data_ptr() % 16 for t in srcs)


def remote_halo_window(srcs, nl: int, nr: int) -> torch.Tensor:
    """Every shard's x window ``[left halo | rows | right halo]`` (see the
    module docstring) as the rows of a fresh ``(d, nl + n + nr)`` tensor,
    the global ends zero."""
    srcs = list(srcs)
    _check(srcs, nl, nr)
    dev = srcs[0].device
    if dev.type == "cpu":
        return remote_halo_window_plain(srcs, nl, nr)
    if dev.type != "cuda":
        raise ValueError(f"no remote_halo kernel for device {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"shards on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    d, n = len(srcs), srcs[0].numel()
    width = nl + n + nr
    out = torch.empty((d, width), dtype=torch.float32, device=dev)
    if width:
        from .._build import cuda_kernels

        vec = vector_path(srcs, n, nl, nr)
        rc = cuda_kernels().remote_halo_window_launch(
            d, n, nl, nr, width, int(vec),
            _Table(*(t.data_ptr() for t in srcs)), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"remote_halo kernel launch failed: "
                               f"cudaError {rc}")
        global launches, scalar_launches
        launches += 1
        scalar_launches += not vec
    return out
