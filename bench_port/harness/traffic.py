"""The general traffic generator: every input of a run from ``--seed``.

A mix file (``traffic/<mix>.json``) holds parameters only; this module turns
them and the seed into inputs:

- right-hand sides: standard normals in float32 from a generator seeded by
  (seed, stream, index), made on the device in one call and widened to
  float64 there, so the same (seed, index) gives the same vector, and the
  check after the window can make it again instead of keeping it;
- diagonal shifts of a time step, s_k = 2^-j_k: the exponents j run through
  the mix's list in an order drawn from the seed, block by block (each
  block a permutation of the list). Every seed then sees the same set of
  shifts in another order, so the seed changes the order of the work and
  not its amount; each s_k is exact in float32;
- which answers the check samples: a reservoir of a fixed size over all
  the answers of the window, drawn from the seed.
"""

from __future__ import annotations

import hashlib
import random

import torch


def stream_seed(seed: int, stream: str, index: int) -> int:
    """A 63-bit seed for item ``index`` of ``stream`` under the run's
    ``seed`` (any whole number)."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}:{int(index)}".encode())
    return int.from_bytes(digest.digest()[:8], "little") >> 1


def rhs(n: int, seed: int, index: int, device, stream: str = "rhs"
        ) -> torch.Tensor:
    """Right-hand side ``index`` of the run: n float32 standard normals
    made on ``device``, as float64."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream, index))
    v = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    return v.to(torch.float64)


def shift_exponent(exponents, seed: int, k: int) -> int:
    """Exponent j_k of step k: steps run through ``exponents`` in blocks,
    each block a permutation drawn from (seed, block)."""
    m = len(exponents)
    order = [int(j) for j in exponents]
    random.Random(stream_seed(seed, "shift", k // m)).shuffle(order)
    return order[k % m]


def shift(j: int) -> float:
    """s = 2^-j: a power of two, exact in float32 and float64."""
    return 2.0 ** -int(j)


class Reservoir:
    """A uniform sample of at most ``size`` of the items offered, drawn from
    the seed (Algorithm R). ``offer`` says which of the ``size`` slots the
    item took, or None, so that the caller can keep what belongs to it in
    storage of its own."""

    def __init__(self, size: int, seed: int):
        self.size = int(size)
        self.rng = random.Random(stream_seed(seed, "sample", 0))
        self.seen = 0
        self.items = []

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
            return len(self.items) - 1
        k = self.rng.randrange(self.seen)
        if k < self.size:
            self.items[k] = item
            return k
        return None
