"""Build-on-first-use of the port's two native libraries.

Counterpart of the build logic in ``omp_amg_tpu/native.py`` (``make -C
csrc``), with two differences:

- the libraries land in ``omp_amg_tpu_torch/_build/`` (listed in
  ``.gitignore``) under a name keyed by a hash of the host, the compiler, its
  flags and the sources, so an existing file is always the build of exactly
  these sources on this machine. The committed ``csrc/libamgnative.so`` is
  never loaded: it was built with ``-march=native`` on another host, and an
  mtime check proves nothing after a fresh checkout;
- each build runs under an exclusive file lock and lands by ``os.replace``
  of a temporary file, so concurrent processes (pytest-xdist workers) never
  load a half-written library.

``native_library()`` builds ``csrc/native.cc`` with g++ and exactly the
CXXFLAGS of ``csrc/Makefile``, so the host setup is bit-identical to the
reference's on the same machine; the port's own host source
(``omp_amg_tpu_torch/csrc/d2_color.cc``, the uncapped colouring) goes into
the same library. ``cuda_library()`` builds
``omp_amg_tpu_torch/csrc/*.cu`` with nvcc for Hopper (``sm_90a``) into one
library with a plain C interface, loaded with ctypes. Each compiler run
is a ``build.<library>`` span under ``torch.profiler``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

from .utils.trace import span

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"
NATIVE_SOURCES = (_PKG.parent / "csrc" / "native.cc",
                  _PKG / "csrc" / "d2_color.cc")
CUDA_SOURCE_DIR = _PKG / "csrc"
# csrc/Makefile:2, verbatim
NATIVE_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
                "-std=c++17", "-Wall")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_cuda_lib = None


def _compile(stem: str, compiler: str, flags, sources) -> Path:
    """Compile ``sources`` into ``_build/<stem>-<hash>.so`` unless that file
    exists; returns its path. Raises RuntimeError when the compiler fails.

    The hash covers the host too: ``-march=native`` code built on one
    machine may fault on another that shares the checkout."""
    h = hashlib.sha256(" ".join((platform.node(), platform.machine(),
                                 compiler, *flags)).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if out.exists():                   # another process built it
            return out
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{stem}-",
                                   suffix=".so")
        os.close(fd)
        try:
            with span(f"build.{stem}"):
                proc = subprocess.run(
                    [compiler, *flags, "-o", tmp,
                     *(str(s) for s in sources)],
                    capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{compiler} failed to build {stem} "
                    f"(exit {proc.returncode}):\n{proc.stderr[-4000:]}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def native_library() -> Path:
    """Path of the host setup library (``csrc/native.cc`` and the port's
    ``csrc/d2_color.cc``), built if needed."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: cannot build csrc/native.cc")
    return _compile("libamgnative", cxx, NATIVE_FLAGS, NATIVE_SOURCES)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if nvcc is None and os.path.exists(default):
        nvcc = default
    if nvcc is None:
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels")
    return nvcc


def cuda_library() -> Path:
    """Path of the CUDA kernel library (``omp_amg_tpu_torch/csrc/*.cu``),
    built if needed."""
    sources = sorted(CUDA_SOURCE_DIR.glob("*.cu"))
    return _compile("libamgkernels", _nvcc(), NVCC_FLAGS, sources)


def cuda_kernels() -> ctypes.CDLL:
    """The loaded CUDA kernel library with every entry point's argtypes set
    (pointers and the stream as ``c_void_p``: left undeclared, ctypes would
    pass them as 32-bit ints)."""
    global _cuda_lib
    if _cuda_lib is None:
        lib = ctypes.CDLL(str(cuda_library()))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        # mode, bf16, vec, n_rows, x_base, indptr, indices, vals, x, v, b,
        # s, out, stream
        lib.csr_spmv_launch.argtypes = [i32, i32, i32, i64, i64] + [p] * 9
        lib.csr_spmv_launch.restype = i32
        # mode, bf16, vec, n_tiles, window, tile_rows, tile_ptr, tile_cols,
        # indptr, indices, vals, x, v, b, s, out, stream
        lib.tile_csr_launch.argtypes = [i32, i32, i32, i64, i32] + [p] * 12
        lib.tile_csr_launch.restype = i32
        # mode, dtype (0 f32, 1 bf16, 2 f64), vec, n, ndiag, offsets (host
        # int32), data, x, x_base, x_len, b, s, out, stream
        lib.dia_spmv_launch.argtypes = ([i32, i32, i32, i64, i32] + [p] * 3
                                        + [i64, i64] + [p] * 4)
        lib.dia_spmv_launch.restype = i32
        # mode, nz, ny, nx, zchunk, ntaps, taps (host), coeffs (host), s, x,
        # b, p, out, stream
        lib.const_stencil_launch.argtypes = ([i32, i64, i64, i64, i64, i32, p,
                                              p, ctypes.c_float] + [p] * 5)
        lib.const_stencil_launch.restype = i32
        # n_rows, C, q, indptr, indices, vals, x, u, stream
        lib.panel_spmm_launch.argtypes = [i64, i32, i32] + [p] * 6
        lib.panel_spmm_launch.restype = i32
        # kind, f64, fz, fy, fx, cz, cy, cx, mask, lanes, rows, zchunk,
        # tiles_x, tiles_y, blocks, in, x, out, stream
        lib.grid_transfer_launch.argtypes = ([i32, i32] + [i64] * 6
                                             + [i32, i32, i32] + [i64] * 4
                                             + [p] * 4)
        lib.grid_transfer_launch.restype = i32
        # kind, f64, n, max_blocks, active, scalar, u, v, s, t, stream
        lib.pcg_update_launch.argtypes = [i32, i32, i64, i64] + [p] * 7
        lib.pcg_update_launch.restype = i32
        # kind, n, max_blocks, scalar, v (f64), f (f32), stream
        lib.ir_f64_launch.argtypes = [i32, i64, i64, ctypes.c_double] + [p] * 3
        lib.ir_f64_launch.restype = i32
        # R, S, W, w, idx, out, stream
        lib.extract_lanes_launch.argtypes = [i64, i64, i64] + [p] * 4
        lib.extract_lanes_launch.restype = i32
        # d, n, nl, nr, stride, vec, src table (a host array of d device
        # pointers), lo, hi, dst, stream
        lib.remote_halo_window_launch.argtypes = ([i32, i64, i64, i64, i64,
                                                   i32] + [p] * 5)
        lib.remote_halo_window_launch.restype = i32
        # the cross-process form's mailboxes (CUDA IPC)
        lib.remote_halo_handle_bytes.argtypes = []
        out = ctypes.POINTER(p)
        lib.remote_halo_mailbox_alloc.argtypes = [i32, i64, out]
        lib.remote_halo_mailbox_free.argtypes = [i32, p]
        lib.remote_halo_ipc_handle.argtypes = [p, p]
        lib.remote_halo_ipc_open.argtypes = [i32, p, out]
        lib.remote_halo_ipc_close.argtypes = [p]
        # box, first, nr, last, n, nl, stream
        lib.remote_halo_post.argtypes = [p, p, i64, p, i64, i64, p]
        for fn in (lib.remote_halo_handle_bytes, lib.remote_halo_mailbox_alloc,
                   lib.remote_halo_mailbox_free, lib.remote_halo_ipc_handle,
                   lib.remote_halo_ipc_open, lib.remote_halo_ipc_close,
                   lib.remote_halo_post):
            fn.restype = i32
        _cuda_lib = lib
    return _cuda_lib
