"""The hand-written kernels' wrappers, one module each, and the dispatch
between them (``spmv.py``).

Every kernel module counts its launches in a module-level ``launches``
(CUDA launches only: the plain twins on CPU tensors count nothing).
:func:`launch_counts` reads them all at once, outside any solve.
"""

from __future__ import annotations

import functools
import importlib
import pkgutil


@functools.cache
def kernel_modules() -> tuple:
    """Every module of this package with a ``launches`` counter, by name,
    imported on the first call (not when the package is)."""
    names = sorted(info.name for info in pkgutil.iter_modules(__path__))
    mods = (importlib.import_module(f"{__name__}.{n}") for n in names)
    return tuple(m for m in mods if hasattr(m, "launches"))


def launch_counts() -> dict:
    """{kernel module: launches so far in this process}; two readings
    around a call give its launches by kernel."""
    return {m.__name__.rsplit(".", 1)[1]: m.launches
            for m in kernel_modules()}
