"""Bytes of a sparse product y = A·x, counted from the operator object at
run time: each input byte read once, each output byte written once, what
the kernel reads again not counted. A change to a level's storage changes
the count with it.

The operator is read by what it holds, not by its class:

- banded planes (``data``, ``offsets``): every plane entry, x and y;
- compressed rows (``indptr``, ``indices``, ``vals``): the three arrays, x
  (``n_cols`` entries) and y;
- a matrix-free stencil (``coeffs``, ``taps``): x, y and the coefficients
  and taps it is handed.

Every kernel these products reach is bound by memory, not arithmetic (2
flops per stored entry against 6 to 12 bytes), so the roofline time is
bytes over the card's peak bandwidth.
"""

from __future__ import annotations

import torch


def _nbytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


def spmv_bytes(op, x_itemsize: int = 4, y_itemsize: int = 4) -> int:
    n_rows = int(op.n_rows)
    if hasattr(op, "indptr"):
        n_cols = int(op.n_cols)
        return (_nbytes(op.indptr) + _nbytes(op.indices) + _nbytes(op.vals)
                + n_cols * x_itemsize + n_rows * y_itemsize)
    if hasattr(op, "coeffs"):
        taps = len(op.coeffs)
        return n_rows * (x_itemsize + y_itemsize) + taps * (4 + 3 * 4)
    if hasattr(op, "data") and hasattr(op, "offsets"):
        data = op.data
        if not isinstance(data, torch.Tensor):
            raise TypeError("a banded operator on the host has no device "
                            "product to count")
        return _nbytes(data) + n_rows * (x_itemsize + y_itemsize)
    raise TypeError(f"cannot count the bytes of {type(op).__name__}")


def roofline_pct(nbytes: int, ms: float, peak_bytes_per_s: float) -> float:
    """The least time the card could take for ``nbytes``, as a percentage
    of the measured ``ms``."""
    return 100.0 * (nbytes / peak_bytes_per_s) / (ms * 1e-3)
