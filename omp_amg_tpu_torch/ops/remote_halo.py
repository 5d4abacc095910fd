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

The cross-process form (a ``ShardMesh`` over several processes on one
card): ``outer=(lo, hi)`` gives the kernel two more sources, the left
neighbour's last nl rows and the right neighbour's first nr rows, read from
the neighbours' mailboxes (:class:`Mailboxes`: one ``cudaMalloc`` buffer
per process, opened by the others through CUDA IPC); None at a global end
zero-fills. ``ipc_launches`` counts the launches of this form.

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
ipc_launches = 0     # of those, launches of the cross-process form


def remote_halo_window_plain(srcs, nl: int, nr: int, lo=None,
                             hi=None) -> torch.Tensor:
    """Plain PyTorch twin: the ``(d, nl + n + nr)`` windows by slicing,
    the outer strips ``lo`` (nl rows) and ``hi`` (nr rows) or
    ``new_zeros`` at the global ends, and one ``torch.cat``."""
    d, n = len(srcs), srcs[0].numel()
    parts = []
    for i, x in enumerate(srcs):
        parts += [srcs[i - 1][n - nl:] if i > 0
                  else lo if lo is not None else x.new_zeros(nl), x,
                  srcs[i + 1][:nr] if i < d - 1
                  else hi if hi is not None else x.new_zeros(nr)]
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


def vector_path(srcs, n: int, nl: int, nr: int, outer=(None, None)) -> bool:
    """True when the exchange takes the kernel's vector path: 4 floats (16
    bytes) divide n, nl and nr, and every shard (and outer strip) starts on
    a 16-byte boundary."""
    if n % 4 or nl % 4 or nr % 4:
        return False
    ptrs = [t.data_ptr() for t in srcs] + [p for p in outer if p]
    return not any(p % 16 for p in ptrs)


def remote_halo_window(srcs, nl: int, nr: int,
                       outer=None) -> torch.Tensor:
    """Every shard's x window ``[left halo | rows | right halo]`` (see the
    module docstring) as the rows of a fresh ``(d, nl + n + nr)`` tensor,
    the global ends zero. ``outer=(lo, hi)``: the cross-process form's
    outer strips, device addresses (ints, None at a global end)."""
    srcs = list(srcs)
    _check(srcs, nl, nr)
    dev = srcs[0].device
    if dev.type == "cpu":
        if outer is not None:
            raise NotImplementedError("the cross-process form reads device "
                                      "addresses: CUDA only")
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

        lo, hi = outer if outer is not None else (None, None)
        vec = vector_path(srcs, n, nl, nr, (lo, hi))
        rc = cuda_kernels().remote_halo_window_launch(
            d, n, nl, nr, width, int(vec),
            _Table(*(t.data_ptr() for t in srcs)), lo, hi, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"remote_halo kernel launch failed: "
                               f"cudaError {rc}")
        global launches, scalar_launches, ipc_launches
        launches += 1
        scalar_launches += not vec
        ipc_launches += outer is not None
    return out


def _ok(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"remote_halo {what} failed: cudaError {rc}")


class Mailboxes:
    """The cross-process form's mailboxes on a mesh over processes (CUDA):
    one ``cudaMalloc`` buffer per process, two slots of ``cap`` floats,
    each slot ``[my first nr rows | my last nl rows]``; the neighbours'
    buffers opened here by CUDA IPC. Every call is collective: each rank
    makes the same calls in the same order (the sharded solve does).

    One exchange (:meth:`exchange`): copy my two strips into slot ``k mod
    2`` (``remote_halo_post``), synchronise my stream, barrier (every
    neighbour's copy has landed), then one window launch that reads the
    neighbours' slot ``k mod 2``. A rank rewrites a slot two exchanges
    later, after the next barrier, by which time every rank has
    synchronised its stream past the launch that read it. The buffers
    grow (collectively, after a sync and a barrier) when an exchange needs
    more than ``cap``."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.cap = 0            # floats per slot
        self.own = None         # my buffer's device address
        self.left = None        # rank − 1's buffer, opened here
        self.right = None       # rank + 1's buffer, opened here
        self.exchanges = 0

    def _lib(self):
        from .._build import cuda_kernels

        return cuda_kernels()

    def _quiesce(self) -> None:
        torch.cuda.current_stream(self.mesh.device).synchronize()
        self.mesh.barrier()

    def _release(self) -> None:
        lib = self._lib()
        for p in (self.left, self.right):
            if p:
                _ok(lib.remote_halo_ipc_close(p), "cudaIpcCloseMemHandle")
        if self.own:
            _ok(lib.remote_halo_mailbox_free(self.mesh.device.index,
                                             self.own), "cudaFree")
        self.own = self.left = self.right = None
        self.cap = 0

    def _grow(self, need: int) -> None:
        lib = self._lib()
        mesh, dev = self.mesh, self.mesh.device.index
        self._quiesce()         # nobody reads the old buffers any more
        self._release()
        cap = -(-max(need, 1024) // 64) * 64    # 256-byte slots
        own = ctypes.c_void_p()
        _ok(lib.remote_halo_mailbox_alloc(dev, 2 * cap * 4,
                                          ctypes.byref(own)), "cudaMalloc")
        nb = lib.remote_halo_handle_bytes()
        handle = (ctypes.c_char * nb)()
        _ok(lib.remote_halo_ipc_handle(own, ctypes.cast(handle,
                                                        ctypes.c_void_p)),
            "cudaIpcGetMemHandle")
        handles = mesh.all_gather(torch.frombuffer(bytearray(handle.raw),
                                                   dtype=torch.uint8))
        self.own, self.cap = own.value, cap

        def open_(rank):
            ptr = ctypes.c_void_p()
            raw = (ctypes.c_char * nb).from_buffer_copy(
                bytes(handles[rank].tolist()))
            _ok(lib.remote_halo_ipc_open(dev, ctypes.cast(raw,
                                                          ctypes.c_void_p),
                                         ctypes.byref(ptr)),
                f"cudaIpcOpenMemHandle of rank {rank}'s mailbox")
            return ptr.value

        if mesh.rank > 0:
            self.left = open_(mesh.rank - 1)
        if mesh.rank + 1 < mesh.world:
            self.right = open_(mesh.rank + 1)
        mesh.barrier()          # every rank has opened its neighbours'

    def exchange(self, xs, nl: int, nr: int) -> torch.Tensor:
        """The windows of this rank's shards ``xs`` (see the class
        docstring) as the rows of a fresh ``(len(xs), nl + n + nr)``
        tensor."""
        xs = list(xs)
        _check(xs, nl, nr)
        if xs[0].device.type != "cuda":
            raise NotImplementedError("the cross-process form reads device "
                                      "addresses: CUDA only")
        if nl + nr > self.cap:
            self._grow(nl + nr)
        n = xs[0].numel()
        slot = self.own + (self.exchanges % 2) * self.cap * 4
        stream = torch.cuda.current_stream(self.mesh.device)
        _ok(self._lib().remote_halo_post(
            slot, xs[0].data_ptr(), nr, xs[-1].data_ptr(), n, nl,
            stream.cuda_stream), "strip copy")
        self._quiesce()
        outer = self.outer(self.exchanges, nl, nr)
        self.exchanges += 1
        return remote_halo_window(xs, nl, nr, outer=outer)

    def outer(self, k: int, nl: int, nr: int):
        """The kernel's outer entries for exchange ``k``: (the left
        neighbour's last ``nl`` rows, the right neighbour's first ``nr``),
        device addresses in their slot ``k mod 2``; None at a global end.
        A slot's strips stay valid until exchange ``k + 2`` posts."""
        off = (k % 2) * self.cap * 4
        return (self.left + off + nr * 4 if self.left and nl else None,
                self.right + off if self.right and nr else None)

    def close(self) -> None:
        """Release the buffers (collective)."""
        if self.own:
            self._quiesce()
            self._release()
