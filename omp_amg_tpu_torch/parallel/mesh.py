"""The shard mesh: counterpart of ``jax.make_mesh((d,), ("rows",))``.

A sharded vector is a list of ``d`` per-shard tensors (contiguous blocks of
rows, shard 0 first); a replicated vector is one tensor, held once, since
every shard of a ``ShardMesh`` lives on the same device. Collectives are
sums and maxima over the list.
"""

from __future__ import annotations

import torch

from ..utils.device import resolve_device


class ShardMesh:
    """``size`` shards on one device (``"cuda"`` by default; without CUDA
    that raises, and a CPU run passes ``"cpu"``)."""

    def __init__(self, size: int, device="cuda"):
        if int(size) < 1:
            raise ValueError(f"a mesh needs at least one shard, got {size}")
        self.size = int(size)
        # the concrete device ("cuda" → "cuda:0"), as tensors carry it
        self.device = torch.empty(0, device=resolve_device(device)).device

    def shard(self, x: torch.Tensor) -> list:
        """Split a full-length vector into ``size`` contiguous blocks on the
        mesh's device."""
        x = x.to(self.device)
        if x.dim() != 1 or x.numel() % self.size:
            raise ValueError(f"a vector of {x.numel()} rows does not split "
                             f"into {self.size} equal shards")
        return [c.contiguous() for c in torch.chunk(x, self.size)]

    @staticmethod
    def gather(parts) -> torch.Tensor:
        """The full vector of a sharded one."""
        return torch.cat(list(parts))


def psum(parts):
    """Sum over shards, in shard order (((p0 + p1) + p2) + …): the order
    decides the last bit of every dot product, so it is fixed."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def pmax(parts):
    """Maximum over shards, in shard order."""
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p)
    return out
