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
reference's on the same machine. ``cuda_library()`` builds
``omp_amg_tpu_torch/csrc/*.cu`` with nvcc for Hopper (``sm_90a``) into one
library with a plain C interface, loaded with ctypes.
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

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"
NATIVE_SOURCE = _PKG.parent / "csrc" / "native.cc"
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
            proc = subprocess.run(
                [compiler, *flags, "-o", tmp, *(str(s) for s in sources)],
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
    """Path of the host setup library (``csrc/native.cc``), built if
    needed."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: cannot build csrc/native.cc")
    return _compile("libamgnative", cxx, NATIVE_FLAGS, [NATIVE_SOURCE])


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
        # mode, bf16, vec, n_rows, indptr, indices, vals, x, v, b, s, out,
        # stream
        lib.csr_spmv_launch.argtypes = [i32, i32, i32, i64] + [p] * 9
        lib.csr_spmv_launch.restype = i32
        # mode, bf16, vec, n, ndiag, offsets (host int32), data, x, x_base,
        # x_len, b, s, out, stream
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
        # R, S, W, w, idx, out, stream
        lib.extract_lanes_launch.argtypes = [i64, i64, i64] + [p] * 4
        lib.extract_lanes_launch.restype = i32
        # d, n, nl, nr, stride, vec, src table (a host array of d device
        # pointers), dst, stream
        lib.remote_halo_window_launch.argtypes = ([i32, i64, i64, i64, i64,
                                                   i32] + [p] * 3)
        lib.remote_halo_window_launch.restype = i32
        _cuda_lib = lib
    return _cuda_lib
