"""The plain reference that decides ``correct``.

It rebuilds the operator of a cell on its own, from the configuration and
the shift the traffic handed to the program, in float64: the stencil the
configuration states (``"stencil"``: taps and coefficients) on a grid of
``n`` points per axis with Dirichlet boundaries (boundary unknowns
eliminated, so a neighbour outside the grid contributes nothing), plus
``shift`` on the diagonal, applied by shifted slices of an ``(n,) * dim``
array. It then judges an answer x of the program by its true relative
residual ``||b - A x|| / ||b||``.

Plain PyTorch: it imports nothing of the program under test nor of the
harness, and takes nothing the program made but the answer it judges.
"""

from __future__ import annotations

import torch


def _window(d: int, n: int) -> tuple:
    """(rows, neighbours): the slices of one axis where row i reads i + d
    inside the grid."""
    if d >= 0:
        return slice(0, n - d), slice(d, n)
    return slice(-d, n), slice(0, n + d)


def apply_stencil(taps, coefficients, x: torch.Tensor,
                  shift: float = 0.0) -> torch.Tensor:
    """y = (A + shift·I) x for the stencil (``taps[k]`` a neighbour's
    offset along each axis of ``x``, ``coefficients[k]`` its weight) with
    Dirichlet boundaries, on the grid of ``x`` (float64)."""
    y = shift * x
    for tap, c in zip(taps, coefficients):
        rows, cols = zip(*(_window(int(d), n) for d, n in zip(tap, x.shape)))
        y[rows] += float(c) * x[cols]
    return y


def rel_residual(config: dict, shift: float, b: torch.Tensor,
                 x: torch.Tensor) -> float:
    """True float64 relative residual of the answer ``x`` to ``b`` under
    the configuration's operator plus ``shift`` on the diagonal. ``b`` and
    ``x`` are flat, in the grid's C order, on any device."""
    st = config["stencil"]
    n = int(config["n"])
    grid = (n,) * len(st["taps"][0])
    b = b.detach().to(torch.float64).reshape(grid)
    x = x.detach().to(b.device, torch.float64).reshape(grid)
    r = b - apply_stencil(st["taps"], st["coefficients"], x, shift)
    bnorm = torch.linalg.vector_norm(b)
    if float(bnorm) == 0.0:
        return float(torch.linalg.vector_norm(r))
    return float(torch.linalg.vector_norm(r) / bnorm)
