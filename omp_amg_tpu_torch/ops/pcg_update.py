"""The PCG programs' vector updates, in place: the hand-written CUDA kernel,
its plain twin, the wrappers and their launch counter.

The kernel is ``omp_amg_tpu_torch/csrc/pcg_update.cu``. It replaces no TPU
kernel: the reference's PCG updates are plain ``jnp`` inside its jitted
loop, outside Pallas. In the port's captured step the updates were torch
operations (a multiply by a 0-dim device scalar and an add per update, and a
``torch.where(active, new, old)`` per state vector), which set the pace of
the structured solve on the card; that where-form, written back in place,
stays as the plain twin. Two entry points, f32 or f64, bit for bit the
twin's result:

- :func:`xr` ``x ← x + α·p`` and ``r ← r − α·q`` in one pass;
- :func:`p_update` ``p ← z + β·p``.

α and β are 0-dim tensors on the vectors' device. ``active`` is the step's
0-dim bool flag, or None (always): where it is false nothing is written, so
a frozen iteration leaves the state as it was.

The wrappers run the plain twin for CPU tensors only. For CUDA tensors they
launch the kernel or raise; nothing falls back.
"""

from __future__ import annotations

import torch

from ..utils.device import sm_count

BLOCKS_PER_SM = 8    # the grid the wrappers ask for: 8 blocks of 256 an SM
DTYPES = (torch.float32, torch.float64)

launches = 0         # kernel launches by the wrappers (CUDA only)


def _check(outs, ins, scalar: torch.Tensor, active) -> None:
    """Raise unless the written vectors ``outs`` and the read ones ``ins``
    are one-dimensional, of one length, one float type and one device, and
    contiguous; ``scalar`` a 0-dim tensor of that type there, ``active``
    None or a 0-dim bool there; and no written vector shares its data with
    another operand."""
    vecs = (*outs, *ins)
    ref = vecs[0]
    if ref.dtype not in DTYPES:
        raise ValueError(f"pcg_update takes float32 or float64, got "
                         f"{ref.dtype}")
    for v in vecs:
        if v.dtype != ref.dtype:
            raise ValueError(f"vectors of different types: {ref.dtype} and "
                             f"{v.dtype}")
        if v.dim() != 1 or v.shape != ref.shape:
            raise ValueError(f"vectors must be one-dimensional of one length, "
                             f"got {tuple(ref.shape)} and {tuple(v.shape)}")
        if v.device != ref.device:
            raise ValueError("vectors on different devices")
        if not v.is_contiguous():
            raise ValueError("pcg_update operands must be contiguous")
    if scalar.dim() != 0 or scalar.dtype != ref.dtype or \
            scalar.device != ref.device:
        raise ValueError(f"the scalar must be a 0-dim {ref.dtype} tensor on "
                         f"{ref.device}, got {scalar.dtype} of shape "
                         f"{tuple(scalar.shape)} on {scalar.device}")
    if active is not None and (active.dim() != 0 or
                               active.dtype != torch.bool or
                               active.device != ref.device):
        raise ValueError(f"active must be None or a 0-dim bool tensor on "
                         f"{ref.device}")
    for i, o in enumerate(outs):
        if o.numel() and any(o.data_ptr() == v.data_ptr()
                             for j, v in enumerate(vecs) if j != i):
            raise ValueError("a written vector shares its data with another "
                             "operand")


def xr_twin(x, r, p, q, alpha, active) -> None:
    """The plain twin of :func:`xr`: the where-form, written back."""
    x_n = x + alpha * p
    r_n = r - alpha * q
    if active is not None:
        x_n = torch.where(active, x_n, x)
        r_n = torch.where(active, r_n, r)
    x.copy_(x_n)
    r.copy_(r_n)


def p_twin(p, z, beta, active) -> None:
    """The plain twin of :func:`p_update`."""
    p_n = z + beta * p
    if active is not None:
        p_n = torch.where(active, p_n, p)
    p.copy_(p_n)


def _launch(kind: int, n: int, scalar, active, u, v, s, t) -> None:
    """The kernel on CUDA tensors (``kind`` 0: xr, 1: p)."""
    if u.device.type != "cuda":
        raise ValueError(f"no pcg_update kernel for device {u.device}")
    if u.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {u.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    from .._build import cuda_kernels

    def ptr(tensor):
        return None if tensor is None else tensor.data_ptr()
    rc = cuda_kernels().pcg_update_launch(
        kind, int(u.dtype == torch.float64), n,
        BLOCKS_PER_SM * sm_count(u.device.index), ptr(active), ptr(scalar),
        ptr(u), ptr(v), ptr(s), ptr(t),
        torch.cuda.current_stream(u.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pcg_update kernel launch failed: cudaError {rc}")
    global launches
    launches += 1


def xr(x, r, p, q, alpha, active=None) -> None:
    """x ← x + α·p and r ← r − α·q in place, where ``active`` (None:
    always)."""
    _check((x, r), (p, q), alpha, active)
    if x.device.type == "cpu":
        xr_twin(x, r, p, q, alpha, active)
    else:
        _launch(0, x.numel(), alpha, active, x, r, p, q)


def p_update(p, z, beta, active=None) -> None:
    """p ← z + β·p in place, where ``active`` (None: always)."""
    _check((p,), (z,), beta, active)
    if p.device.type == "cpu":
        p_twin(p, z, beta, active)
    else:
        _launch(1, p.numel(), beta, active, p, None, z, None)
