"""The certified loop's float64 vector work: the hand-written CUDA kernels,
their plain twins, the wrappers and their launch counter.

The loop (``solvers/ir.py::solve_ir_device``) keeps b, x and the user's
fine operator in float64 on the device and, per outer pass, forms

- :func:`residual` ``r = b − A·x`` in one pass over the f64 planes:
  ``csrc/dia_spmv.cu``'s kernel instantiated on double (mode residual, a
  thread per row: its 16-byte-load path gains nothing on 8-byte values);
  :func:`spmv` is its spmv mode, which the z-slab mesh loop
  (``parallel/dist_ir.py``) runs per shard over its exchanged window;
- :func:`defect` the f32 right-hand side of the inner PCG, ``r / ‖r‖``
  cast to float32 (``csrc/ir_f64.cu``);
- :func:`update` ``x ← x + ‖r‖·x_inner`` in place (``csrc/ir_f64.cu``).

They replace no TPU kernel: the reference forms them with plain ``jnp`` in
double-float32 pairs. Each is bit for bit the torch form the loop ran
before, kept here as its twin: :func:`dia_apply_f64` (taps summed in
ascending order over a zero-padded x), ``b − y``, the defect and the
update. PyTorch evaluates ``r / rnorm`` on a CUDA tensor as ``r · (1 /
rnorm)``, the reciprocal formed in double on the host, so that is what the
loop computed on the card, and what the defect's kernel and twin compute.

The wrappers run the plain twin for CPU tensors only. For CUDA tensors they
launch the kernel or raise; nothing falls back. ``launches`` counts every
launch (a certified solve: one residual per outer pass and one for the final
check, one defect and one update per inner solve).
"""

from __future__ import annotations

import torch

from ..sparse.formats import Dia
from ..utils.device import sm_count
from .dia_spmv import MAX_DIAG

BLOCKS_PER_SM = 8    # the stream kernels' grid: 8 blocks of 256 an SM

launches = 0         # kernel launches by the wrappers (CUDA only)


# --- the plain twins: the loop's torch forms ---------------------------------

def dia_apply_f64(offsets, data: torch.Tensor, x: torch.Tensor,
                  x_base: int = 0, n_rows: int | None = None
                  ) -> torch.Tensor:
    """y = A·x in float64 for banded planes ``data`` (``data[k, i]``
    multiplies ``x[x_base + i + offsets[k]]``; f32/bf16 planes are widened
    exactly), taps summed in ascending order, zeros outside ``x``."""
    n = data.shape[1] if n_rows is None else n_rows
    lo = max(0, -min(offsets))
    hi = max(0, max(offsets))
    xp = torch.nn.functional.pad(x.double(), (lo, hi))
    y = torch.zeros(n, dtype=torch.float64, device=x.device)
    for k, off in enumerate(offsets):
        start = x_base + off + lo
        y = y + data[k].double() * xp[start:start + n]
    return y


def residual_twin(a: Dia, x: torch.Tensor, b: torch.Tensor,
                  x_base: int = 0) -> torch.Tensor:
    """The plain twin of :func:`residual`."""
    return b - dia_apply_f64(a.offsets, a.data, x, x_base)


def defect_twin(r: torch.Tensor, rnorm: float) -> torch.Tensor:
    """The plain twin of :func:`defect`: ``(r / rnorm).float()`` as PyTorch
    evaluates it on the card."""
    return (r * (1.0 / rnorm)).float()


def update_twin(x: torch.Tensor, rnorm: float, xi: torch.Tensor) -> None:
    """The plain twin of :func:`update`, written back."""
    x.copy_(x + rnorm * xi.double())


# --- the wrappers ------------------------------------------------------------

def _on_card(t: torch.Tensor) -> bool:
    """False for a CPU tensor (the twin runs); True for a CUDA tensor on the
    current device; raises elsewhere."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no ir_f64 kernel for device {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {t.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return True


def _check_vectors(*pairs) -> None:
    """Raise unless each (tensor, dtype, length) names a contiguous vector
    of that type and length, all on one device."""
    dev = pairs[0][0].device
    for t, dtype, n in pairs:
        if t.dtype != dtype or t.dim() != 1 or t.numel() != n:
            raise ValueError(f"expected a {dtype} vector of {n} values, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError("operands on different devices")
        if not t.is_contiguous():
            raise ValueError("ir_f64 operands must be contiguous")


def _check_dia(a: Dia, x: torch.Tensor, x_base: int) -> None:
    data = a.data
    if not isinstance(data, torch.Tensor) or data.dtype != torch.float64:
        raise TypeError("the f64 residual takes float64 torch planes, got "
                        f"{getattr(data, 'dtype', type(data))}")
    if data.dim() != 2 or data.shape[0] != len(a.offsets):
        raise ValueError("DIA data must be (ndiag, n)")
    if len(a.offsets) > MAX_DIAG:
        raise ValueError(f"{len(a.offsets)} diagonals > kernel limit "
                         f"{MAX_DIAG}")
    if any(abs(o) >= 2 ** 31 for o in a.offsets):
        raise ValueError("DIA offsets must fit in int32")
    if x.dtype != torch.float64 or x.dim() != 1:
        raise ValueError(f"x must be a float64 vector, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not 0 <= x_base <= x.numel() - a.n_rows:
        raise ValueError(f"the window x[{x_base}:{x_base + a.n_rows}] of "
                         f"the {a.n_rows} rows lies outside x ({x.numel()} "
                         "values)")
    if data.device != x.device:
        raise ValueError("operands on different devices")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("ir_f64 operands must be contiguous")


def _lib():
    from .._build import cuda_kernels

    return cuda_kernels()


def _banded(a: Dia, x: torch.Tensor, x_base: int, b) -> torch.Tensor:
    """The f64 DIA kernel on CUDA tensors: mode spmv (``b`` None) or
    residual."""
    out = torch.empty(a.n_rows, dtype=torch.float64, device=x.device)
    rc = _lib().dia_spmv_launch(
        0 if b is None else 1, 2, 0, a.n_rows, len(a.offsets),
        a.offsets_i32, a.data.data_ptr(), x.data_ptr(), x_base, x.numel(),
        None if b is None else b.data_ptr(), None, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"f64 dia_spmv kernel launch failed: cudaError "
                           f"{rc}")
    global launches
    launches += 1
    return out


def _stream(kind: int, n: int, scalar: float, v: torch.Tensor,
            f: torch.Tensor) -> None:
    """``csrc/ir_f64.cu`` on CUDA tensors (``kind`` 0: defect, 1:
    update)."""
    rc = _lib().ir_f64_launch(
        kind, n, BLOCKS_PER_SM * sm_count(v.device.index), scalar,
        v.data_ptr(), f.data_ptr(),
        torch.cuda.current_stream(v.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ir_f64 kernel launch failed: cudaError {rc}")
    global launches
    launches += 1


def spmv(a: Dia, x: torch.Tensor, x_base: int = 0) -> torch.Tensor:
    """y = A·x in float64 (x: the n rows, or a window holding them at
    ``x_base``); ``a`` has float64 torch planes."""
    _check_dia(a, x, x_base)
    if not _on_card(x):
        return dia_apply_f64(a.offsets, a.data, x, x_base)
    return _banded(a, x, x_base, None)


def residual(a: Dia, x: torch.Tensor, b: torch.Tensor,
             x_base: int = 0) -> torch.Tensor:
    """r = b − A·x in float64, in one pass (x as for :func:`spmv`); ``a``
    has float64 torch planes."""
    _check_dia(a, x, x_base)
    _check_vectors((b, torch.float64, a.n_rows), (x, torch.float64,
                                                  x.numel()))
    if not _on_card(x):
        return residual_twin(a, x, b, x_base)
    return _banded(a, x, x_base, b)


def defect(r: torch.Tensor, rnorm: float) -> torch.Tensor:
    """The inner solve's right-hand side ``r / rnorm`` in float32 (as
    ``(r / rnorm).float()`` on the card: r times the reciprocal)."""
    _check_vectors((r, torch.float64, r.numel()))
    inv = 1.0 / rnorm
    if not _on_card(r):
        return defect_twin(r, rnorm)
    out = torch.empty(r.numel(), dtype=torch.float32, device=r.device)
    _stream(0, r.numel(), inv, r, out)
    return out


def update(x: torch.Tensor, rnorm: float, xi: torch.Tensor) -> None:
    """x ← x + rnorm · x_inner in place (x float64, ``xi`` the inner
    solution in float32)."""
    _check_vectors((x, torch.float64, x.numel()),
                   (xi, torch.float32, x.numel()))
    if not _on_card(x):
        update_twin(x, rnorm, xi)
        return
    _stream(1, x.numel(), float(rnorm), x, xi)
