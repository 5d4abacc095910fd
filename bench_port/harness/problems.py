"""The operators the benchmark hands to the program, made by the benchmark.

A configuration states its stencil as data: ``"stencil": {"taps": [[dz,
dy, dx], ...], "coefficients": [...]}`` (a tap of two entries is a 2D
stencil), on a grid of ``n`` points along each axis, with Dirichlet
boundaries whose unknowns are eliminated: a neighbour outside the grid
contributes nothing. The operator goes to the program as banded planes in
its DIA layout: plane k holds the coefficient that multiplies x[i +
offsets[k]], 0 where that neighbour lies outside the grid, offsets
ascending. A time step's operator adds a shift s to the centre plane. Host
planes are float64 numpy (the host setup reads them there); device planes
are float32 made on the card from the row index, in a few large calls (the
coefficients and the shifts 2^-j are exact in float32).
"""

from __future__ import annotations

import numpy as np
import torch


def stencil(config: dict) -> list:
    """[(tap, coefficient)] of the configuration, in ascending offset order
    (the offset of a tap is the same order at any ``n`` > 2·max|tap|)."""
    st = config["stencil"]
    taps = [tuple(int(d) for d in t) for t in st["taps"]]
    coeffs = [float(c) for c in st["coefficients"]]
    if len(taps) != len(coeffs) or len({len(t) for t in taps}) != 1:
        raise ValueError("a stencil needs one coefficient per tap, and taps "
                         "of one dimension")
    if len(set(taps)) != len(taps) or (0,) * len(taps[0]) not in taps:
        raise ValueError("a stencil's taps are distinct and hold the centre")
    big = 1 + 2 * max(abs(d) for t in taps for d in t)
    return sorted(zip(taps, coeffs), key=lambda tc: _flat(tc[0], big))


def _flat(tap, n: int) -> int:
    off = 0
    for d in tap:
        off = off * n + d
    return off


def offsets(n: int, taps) -> tuple:
    return tuple(_flat(t, n) for t, _ in taps)


def host_planes(n: int, taps) -> np.ndarray:
    """(taps, n^dim) float64 planes."""
    dim = len(taps[0][0])
    coords = np.indices((n,) * dim).reshape(dim, -1)
    data = np.zeros((len(taps), n ** dim), np.float64)
    for k, (tap, c) in enumerate(taps):
        ok = np.ones(n ** dim, dtype=bool)
        for axis, d in enumerate(tap):
            if d:
                ok &= (coords[axis] + d >= 0) & (coords[axis] + d < n)
        data[k] = c * ok
    return data


def device_planes(n: int, taps, device) -> torch.Tensor:
    """(taps, n^dim) float32 planes made on ``device``."""
    dim = len(taps[0][0])
    idx = torch.arange(n ** dim, device=device, dtype=torch.int64)
    coords = [(idx // n ** (dim - 1 - a)) % n for a in range(dim)]
    del idx
    data = torch.empty((len(taps), n ** dim), device=device,
                       dtype=torch.float32)
    for k, (tap, c) in enumerate(taps):
        ok = torch.ones_like(coords[0], dtype=torch.bool)
        for axis, d in enumerate(tap):
            if d:
                ok &= (coords[axis] + d >= 0) & (coords[axis] + d < n)
        data[k] = ok.to(torch.float32) * c
    return data


class Problem:
    """A configuration's operator: its planes, made once, and the shifted
    copies a time step hands over (``dia(s)``, a new program ``Dia`` each
    call)."""

    def __init__(self, config: dict, device, on_device: bool):
        from omp_amg_tpu_torch import Dia

        taps = stencil(config)
        self.n = int(config["n"])
        self.dims = (self.n,) * len(taps[0][0])
        self.rows = self.n ** len(self.dims)
        self.offsets = offsets(self.n, taps)
        self.centre = self.offsets.index(0)
        self.planes = (device_planes(self.n, taps, device) if on_device
                       else host_planes(self.n, taps))
        self._dia = Dia

    def dia(self, shift: float = 0.0):
        data = self.planes
        if shift:
            data = data.copy() if isinstance(data, np.ndarray) \
                else data.clone()
            data[self.centre] += shift
        return self._dia(data=data, offsets=self.offsets, dims=self.dims)
