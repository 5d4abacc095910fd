"""Host allocator tuning for the setup phase.

Measured on this 2-core host (round 5, BASELINE.md): glibc serves every
large numpy allocation via mmap, so each multi-hundred-MB setup temporary
(SpGEMM outputs, interp planes, upload pack buffers) faults fresh zero
pages at ~150–200 MB/s — cold-allocation cost rivaled the actual compute
in several phases. Raising M_MMAP_THRESHOLD keeps those blocks on the
sbrk heap, where freed pages stay faulted and numpy's same-size temps
recycle them: 7-pt 128³ classical setup 22.4 → 17.5 s, upload pack
2.3 → 0.15 s (A/B with MALLOC_MMAP_THRESHOLD_).

``tune_malloc()`` applies the same setting at runtime via ``mallopt`` —
idempotent, no-op off glibc or when OMP_AMG_NO_MALLOC_TUNE is set. The
trade: the heap high-water mark persists until ``malloc_trim`` (bench.py
already trims between blocks); on this 125 GB box that is the right
trade for a ~20% setup cut.
"""

from __future__ import annotations

import os

_done = False

M_MMAP_THRESHOLD = -3


def tune_malloc(threshold: int = (1 << 31) - 1) -> bool:
    """Raise glibc's mmap threshold (idempotent). Returns True if applied.

    The mallopt parameter is a C int, so the ceiling is 2 GiB − 1; numpy
    blocks larger than that (rare — only ≥2 GiB single arrays) still go
    through mmap.
    """
    global _done
    if _done:
        return True
    if os.environ.get("OMP_AMG_NO_MALLOC_TUNE"):
        return False
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        ok = bool(libc.mallopt(M_MMAP_THRESHOLD, ctypes.c_int(threshold)))
    except Exception:
        return False
    _done = ok
    return ok


def trim_heap() -> None:
    """Return freed heap pages to the OS (malloc_trim(0)); pairs with
    tune_malloc when a long-lived process wants its high-water mark back
    between large phases."""
    try:
        import ctypes

        ctypes.CDLL(None).malloc_trim(0)
    except Exception:
        pass
