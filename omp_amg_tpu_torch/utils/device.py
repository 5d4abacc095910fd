"""The one place where the port's entry points turn a device argument into a
``torch.device``, and the card properties the kernel wrappers size their
launches by.

``AMGSolver``, ``amg_setup`` and ``hierarchy_from_numpy`` default to
``device="cuda"`` and resolve it here. Without CUDA that raises: nothing
moves to the CPU on its own, and a CPU run says ``device="cpu"``.
"""

from __future__ import annotations

import functools

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises RuntimeError if it is CUDA and
    CUDA is not available."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested but CUDA is not "
                           "available (torch.cuda.is_available() is False); "
                           "pass device='cpu' to run on the CPU")
    return device


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Multiprocessors of CUDA device ``index`` (cached: the wrappers ask on
    every launch)."""
    return torch.cuda.get_device_properties(index).multi_processor_count
