"""The shard mesh: counterpart of ``jax.make_mesh((d,), ("rows",))``.

A sharded vector is a list of per-shard tensors (contiguous blocks of rows,
in shard order). A :class:`ShardMesh` of ``size`` shards spans ``world``
processes (1 unless built over a ``torch.distributed`` group by
:func:`.multihost.global_mesh`): rank r holds shards ``[r·local,
(r+1)·local)`` and a sharded vector is the list of this rank's shards; a
replicated vector is one tensor, held whole by every rank. Collectives are
sums and maxima over the shards in shard order; across processes every
rank's partials are gathered first, so every dot is bitwise the
one-process one and the iteration counts do not depend on how the shards
are spread over processes.

Every transfer between processes goes through :meth:`ShardMesh._transfer`:
a CUDA tensor is staged through a pinned host buffer, moved by gloo and
copied back, so a CPU run and a run on the card take the same code path.
``ShardMesh.stats`` counts its calls, bytes and host seconds.

The module functions take the mesh as an optional last argument: ``None``
(an operator placed without one: every shard in this process) is one
process.
"""

from __future__ import annotations

import time

import torch

from ..utils.device import resolve_device


class ShardMesh:
    """``size`` shards on one device per process (``"cuda"`` by default;
    without CUDA that raises, and a CPU run passes ``"cpu"``), over
    ``world`` processes of which this is ``rank``. Across processes,
    ``"cuda"`` without an index is ``cuda:{rank % device_count}`` (so
    ranks may share a card), which becomes the current device."""

    def __init__(self, size: int, device="cuda", *, world: int = 1,
                 rank: int = 0):
        if int(size) < 1:
            raise ValueError(f"a mesh needs at least one shard, got {size}")
        if int(size) % int(world):
            raise ValueError(f"{size} shards do not split over {world} "
                             "processes")
        self.size = int(size)
        self.world = int(world)
        self.rank = int(rank)
        self.local = self.size // self.world
        self.first = self.rank * self.local
        dev = resolve_device(device)
        if dev.type == "cuda" and self.world > 1:
            if dev.index is None:
                dev = torch.device("cuda",
                                   self.rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        # the concrete device ("cuda" → "cuda:0"), as tensors carry it
        self.device = torch.empty(0, device=dev).device
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
        self._pinned = {}
        self._mail = None       # the remote_halo mailboxes (CUDA IPC)

    def shard(self, x: torch.Tensor) -> list:
        """This rank's shards of a full-length vector."""
        parts = _chunks(x.to(self.device), self.size)
        return parts[self.first:self.first + self.local]

    def gather(self, parts) -> torch.Tensor:
        """The full vector of a sharded one, on every rank."""
        return self.all_gather(torch.cat(list(parts))).reshape(-1)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``(world, *t.shape)``: every rank's ``t``, in rank order."""
        if self.world == 1:
            return t.unsqueeze(0)
        return self._transfer("all_gather", t)[0]

    def strips(self, xs, nl: int, nr: int):
        """(the last ``nl`` rows of rank r − 1's last shard, the first
        ``nr`` rows of rank r + 1's first shard); None at a global end
        (on one process, both)."""
        if self.world == 1 or nl == nr == 0:
            return None, None
        left, right = self._transfer("neighbours", xs[0][:nr],
                                     xs[-1][xs[-1].numel() - nl:])
        return left, right

    def barrier(self) -> None:
        self._transfer("barrier")

    def _pinned_buffer(self, slot, shape, dtype) -> torch.Tensor:
        """A pinned host buffer, reused per slot, shape and type."""
        key = (slot, tuple(shape), dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(shape, dtype=dtype,
                                                  pin_memory=True)
        return buf

    def _host(self, slot, t: torch.Tensor) -> torch.Tensor:
        """``t`` on the host: for a CUDA tensor a pinned buffer, copied
        asynchronously (the caller synchronises); a CPU tensor itself."""
        if t.device.type == "cpu":
            return t.contiguous()
        buf = self._pinned_buffer(slot, t.shape, t.dtype)
        buf.copy_(t, non_blocking=True)
        return buf

    def _recv(self, slot, shape, dtype, device) -> torch.Tensor:
        if device.type == "cpu":
            return torch.empty(shape, dtype=dtype)
        return self._pinned_buffer(slot, shape, dtype)

    def _transfer(self, kind: str, *ts):
        """The one path of every inter-process transfer (module docstring):
        ``"all_gather"`` of one tensor; ``"neighbours"``: ``(to_left,
        to_right)`` → ``(from_left, from_right)``, None at a global end;
        ``"barrier"``."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        nbytes = 0
        if kind == "barrier":
            dist.barrier()
            out = ()
        else:
            dev = ts[0].device
            host = [self._host(("send", i), t) for i, t in enumerate(ts)]
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            if kind == "all_gather":
                h = host[0]
                got = self._recv("gather", (self.world,) + tuple(h.shape),
                                 h.dtype, dev)
                dist.all_gather(list(got.unbind(0)), h)
                recvd = [got]
                nbytes = got.numel() * got.element_size()
            elif kind == "neighbours":
                to_left, to_right = host
                recvd = [None, None]
                reqs = []
                if self.rank > 0 and to_right.numel():
                    recvd[0] = self._recv("left", to_right.shape,
                                          to_right.dtype, dev)
                    reqs.append(dist.irecv(recvd[0], self.rank - 1, tag=1))
                if self.rank > 0 and to_left.numel():
                    reqs.append(dist.isend(to_left, self.rank - 1, tag=0))
                if self.rank + 1 < self.world and to_left.numel():
                    recvd[1] = self._recv("right", to_left.shape,
                                          to_left.dtype, dev)
                    reqs.append(dist.irecv(recvd[1], self.rank + 1, tag=0))
                if self.rank + 1 < self.world and to_right.numel():
                    reqs.append(dist.isend(to_right, self.rank + 1, tag=1))
                for r in reqs:
                    r.wait()
                nbytes = sum(t.numel() * t.element_size() for t in recvd
                             if t is not None)
            else:
                raise ValueError(f"unknown transfer {kind!r}")
            # pinned receive buffers are reused: copy back synchronously
            out = tuple(t if t is None or dev.type == "cpu"
                        else t.to(dev) for t in recvd)
        self.stats["calls"] += 1
        self.stats["bytes"] += nbytes
        self.stats["seconds"] += time.perf_counter() - t0
        return out

    def reset_stats(self) -> None:
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0}

    def remote_windows(self, xs, nl: int, nr: int):
        """Every local shard's window ``[left halo | rows | right halo]``
        through the ``remote_halo`` kernel's cross-process form: the
        neighbours' strips are read from their CUDA IPC mailboxes (see
        :class:`~..ops.remote_halo.Mailboxes`). CUDA only."""
        check_remote(self)
        from ..ops.remote_halo import Mailboxes

        if self._mail is None:
            self._mail = Mailboxes(self)
        return self._mail.exchange(xs, nl, nr)

    def close(self) -> None:
        """Release the IPC mailboxes (collective: every rank calls it)."""
        if self._mail is not None:
            self._mail.close()
            self._mail = None


def _chunks(x: torch.Tensor, d: int) -> list:
    if x.dim() != 1 or x.numel() % d:
        raise ValueError(f"a vector of {x.numel()} rows does not split "
                         f"into {d} equal shards")
    return [c.contiguous() for c in torch.chunk(x, d)]


def spans(mesh) -> bool:
    """Whether ``mesh`` spans several processes."""
    return mesh is not None and mesh.world > 1


def check_remote(mesh) -> None:
    """Raise NotImplementedError where ``transport="remote"`` cannot run:
    between processes off the card."""
    if spans(mesh) and mesh.device.type != "cuda":
        raise NotImplementedError(
            'transport="remote" on a process mesh reads the neighbours\' '
            "device memory through CUDA IPC, which needs CUDA; the plain "
            "twin cannot read another process's memory (on the CPU use "
            'transport="ppermute")')


def first_shard(mesh) -> int:
    """The global index of this process's first shard (0 on one
    process)."""
    return mesh.first if mesh is not None else 0


def gather(parts, mesh=None) -> torch.Tensor:
    """The full vector of a sharded one (on every rank)."""
    return mesh.gather(parts) if mesh is not None else torch.cat(list(parts))


def outer_strips(xs, nl: int, nr: int, mesh=None):
    """The strips beyond this process's shards: (rank r − 1's last ``nl``
    rows, rank r + 1's first ``nr`` rows), None where the neighbour is a
    global end or, on one process, always."""
    if mesh is None:
        return None, None
    return mesh.strips(xs, nl, nr)


def _all_partials(parts, mesh):
    if spans(mesh):
        return list(mesh.all_gather(torch.stack(list(parts))).flatten(0, 1)
                    .unbind(0))
    return list(parts)


def psum(parts, mesh=None):
    """Sum over shards, in shard order (((p0 + p1) + p2) + …): the order
    decides the last bit of every dot product, so it is fixed. On a process
    mesh every rank's partials are gathered first and summed the same
    way."""
    parts = _all_partials(parts, mesh)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def pmax(parts, mesh=None):
    """Maximum over shards, in shard order."""
    parts = _all_partials(parts, mesh)
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p)
    return out
