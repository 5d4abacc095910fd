#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (omp_amg_tpu_torch).

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--n 128]

Phases (each raises on failure, so the exit code is non-zero):

1. the card's name and power limit; CUDA must be available;
2. builds both libraries from the sources in the checkout
   (``csrc/native.cc`` with g++, ``omp_amg_tpu_torch/csrc/*.cu`` with nvcc);
3. PMIS kernel checks: ``dia_spmv`` and ``csr_spmv``, every mode × value
   type on the operators of the ``poisson3d_7pt(n)`` PMIS hierarchy, against
   their plain PyTorch twins on the same CUDA tensors, both timed with CUDA
   events; each CSR operator's lane width V (``Csr.vec``) and, on those
   above 50 k rows, the f32 spmv time at every V (``vsweep`` lines); each
   ``dia_spmv`` check's path (vector or scalar) held against the launch
   counters, and both paths timed where the operands allow both
   (``paths`` lines);
4. the PMIS main path: ``AMGSolver(A, AMGParams(coarsening="pmis"),
   device="cuda").solve(b, tol=1e-8)``; the kernel launches of one
   V-cycle, and a ``torch.profiler`` run of one warm solve (device busy
   share, the largest kernels);
5. iteration parity of the PMIS GPU solve against the port's plain CPU
   solve at 64³;
5a. probe-kernel checks: the ``poisson3d_7pt(n)`` PMIS setup with
   ``rap="probe"``; per level the host Galerkin product, the colouring and
   the device numeric phase, its A_c against the host product; on levels 0
   and 1 ``panel_spmm`` (A·PV and R·U of the first colour group) and
   ``extract_lanes`` against their twins; each ``panel_spmm`` operand also
   on the warp-per-row instance (``psweep`` lines);
5b. the probe main path: ``AMGSolver(A, AMGParams(coarsening="pmis",
   rap="probe"), device="cuda").solve(b, tol=1e-8)``, its hierarchy the one
   checked in 5a, its setup and counts beside phase 4's;
5c. ``bench.py``'s numeric-phase measurement on the card: level 0 of PMIS
   ``poisson3d_7pt(96)``, warm, against the host Galerkin product;
5d. iteration parity of the probe GPU solve against the port's CPU solve
   at 64³;
6. ``const_stencil`` kernel checks: all five modes on the ``ConstDia`` of
   ``poisson3d_7pt(256)``, ``poisson3d_7pt(n)`` and ``poisson3d_27pt(n)``;
   spmv of each at several z-chunk lengths (``zsweep`` lines);
7. the 3D structured main path: ``AMGSolver(poisson3d_7pt(n), AMGParams(),
   grid=(n,)*3, device="cuda").solve(b, tol=1e-8)``; then ``dia_spmv``
   checks on its Galerkin levels;
8. the 2D structured path: the same call for ``poisson2d_5pt(1024)``; then
   ``dia_spmv`` checks on its fine and 512² operators (the operators the
   TPU's ``_dia_kernel`` serves);
9. iteration parity of the structured GPU solves against the port's plain
   CPU solves on ``bench.py``'s structured configs;
10. the z-slab distributed structured path on one card: ``AMGSolver(
   poisson3d_7pt(n), AMGParams(), grid=(n,)*3, mesh=ShardMesh(4, "cuda"),
   transport="remote").solve(b, tol=1e-8)`` (10a; ``remote_halo`` and
   ``dia_spmv`` must both launch), the same solve with ``transport=
   "ppermute"`` (x bitwise equal, counts equal) and on ``ShardMesh(1)``
   (the partition-invariance contract: equal inner counts, a difference of
   one printed with both residual histories), and a ``torch.profiler`` run
   of one warm solve (device busy share, the largest kernels); then (10b)
   ``remote_halo`` on the sharded levels L0, L1, L2 at d = 4 and L0 at
   d = 8: the windows exact against the twin (its path held against the
   launch counters; at L0, d = 4, the scalar path forced too) and against
   the plain exchange, and per shape a ``halo`` line with the exchange's
   device µs on both transports, the bound and the host's enqueue µs per
   exchange; and ``dia_spmv``'s x-window mode on an L0 shard; (10c) the
   sharded GPU/CPU iteration parity at 32³, 4 shards;
11. the options: (11a) ``bench.py``'s ``3d27pt_128_cheby`` (27-point 128³,
   ``AMGParams(smoother="chebyshev")``) structured and PMIS, its counts
   beside the TPU records, then ``dia_spmv`` and ``csr_spmv`` checks on its
   PMIS levels 0 and 1; (11c) on the 7-point n³ PMIS and structured paths
   the device certified loop (``residual="device"``, the default on the
   card) against the host loop: equal counts, ``device_result=True``
   bitwise the host x, warm times and profiles; (11b) there too the W and F
   cycles and the pipelined PCG on that setup (launches of one cycle
   application of each cycle type; the pipelined count standard's or one
   more; profiles of both PCGs, with their device-to-host copies), and
   l1-Jacobi and the ``inv`` coarse solve on their own setups; (11d)
   Chebyshev and the pipelined PCG on the 4-shard path against 1 shard;
   (11e) the GPU/CPU iteration parity of all of them at 32³.

Phases 4-10 call ``solve(b, tol=1e-8)``, whose ``residual="auto"`` forms
the certified residual on the card for a ``Dia`` operator.

Kernel times are CUDA-event means over 20 calls, each after an L2 flush
that reads a 256 MB buffer (a reduction: it leaves only clean lines, where
a write would leave dirty lines for the timed call to write back).

Each main path is driven with every launch counter set to 0 just before it
and read just after (``dia_spmv`` also counts its scalar-path launches
apart); certified and scipy f64 residuals are checked. Every kernel check
also times one PyTorch call that computes the same function, where there is
one (``library_ms``: ``torch.sparse.mm``, ``torch.addmm`` of a sparse CSR
for the residual and correct modes, ``F.conv3d``, ``torch.gather``; a
yardstick the port never calls), and the least time the
card could take (``bound``: the bytes the function must move over the
card's published memory rate, or its operations over its published f32
rate, whichever is larger). The line before the last is a JSON object with
one entry per kernel; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

DIA_BOUND = 1e-6    # ≤ 27 f32 terms summed: only the order may differ
CSR_BOUND = 1e-5    # rows of up to ~100 terms, summed in another order
CONST_BOUND = 0.0   # same products and order as the twin: bitwise
PROBE_BOUND = 0.0   # panel_spmm and extract_lanes: bitwise the twin
HALO_BOUND = 0.0    # remote_halo is a copy: exact
SPIN_CYCLES = 2_000_000  # cuda_ms' spin before each timed call, ~1 ms
SHARDS = 4          # z-slab shards of the distributed path on the one card
SHARD_PARITY_N = 32  # the sharded GPU/CPU iteration-parity grid
RAP_BOUND = 3e-6    # probed A_c against the host product (f32 sums)
SEED = 0            # right-hand side and kernel-check inputs
PARITY_N = 64       # the PMIS GPU/CPU iteration-parity grid
RAP_BENCH_N = 96    # bench.py's BENCH_PMIS_N: its numeric-phase measurement
# bench.py's fourth config, 3d27pt_128_cheby, and its TPU records
# (bench_details.json "configs" and "pmis_configs": inner iterations summed
# over the outer passes, outer passes)
CHEBY_N = 128
TPU_RECORD_CHEBY = {"structured": (10, 2), "pmis": (10, 2)}
VARIANT_PARITY_N = 32   # the options' GPU/CPU iteration-parity grid
# published peaks (NVIDIA data sheets): memory bytes/s and f32 FLOP/s
# outside the tensor cores, by card name; the first match wins
PEAKS = (("H200", 4.8e12, 67e12, "H200 SXM"),
         ("H100 NVL", 3.9e12, 60e12, "H100 NVL"),
         ("H100 PCIe", 2.0e12, 51e12, "H100 PCIe"),
         ("H100", 3.35e12, 67e12, "H100 SXM"))
PEAK = PEAKS[-1]    # set from the card's name in main()
TPU_RECORD_64 = {"inner": 11, "outer": 2}   # bench_details.json
                                            # pmis_configs.3d7pt_64
CONST_N = 256       # bench.py's BENCH_N: the reference's SpMV headline size
N2D = 1024          # the 2D structured path (reaches the TPU's _dia_kernel)
# bench.py's structured configs and their TPU records (bench_details.json
# "configs": inner iterations summed over the outer passes, outer passes)
STRUCTURED_PARITY = {
    "2d5pt_128": ("poisson2d_5pt", (128,), (128, 128), (12, 2)),
    "3d7pt_64": ("poisson3d_7pt", (64,), (64, 64, 64), (14, 2)),
    "aniso9pt_256_eps1e-3": ("aniso2d_9pt", (256,), (256, 256), (18, 2)),
}


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(fn, reps: int = 20, warm: int = 3, flush=None) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` warm calls, each
    between its own pair of CUDA events. With ``flush`` (a tensor larger
    than the 50 MB L2), the L2 is evicted before every timed call by a
    reduction that reads the whole buffer (it leaves only clean lines), and
    a spin of about 1 ms (``torch.cuda._sleep``) then keeps the stream busy
    while the host enqueues the call, so that a call whose enqueue takes
    longer than the flush (a sequence of torch calls: up to 0.24 ms) is
    still timed on the device alone."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.view(torch.float32).sum()
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def card_peak(name: str):
    """(bytes/s, f32 FLOP/s, label) published for the card ``name``."""
    for key, bw, flops, label in PEAKS:
        if key in name:
            return bw, flops, label
    return PEAKS[-1][1], PEAKS[-1][2], f"unknown card: {PEAKS[-1][3]}"


def compare(name, kernel, plain, bound, nbytes, flush, library=None,
            flops=0, flat=None):
    """Run kernel and twin once, check the bound, time both with a cold L2,
    and the ``library`` call (one PyTorch call computing the same function)
    where there is one; a result row. ``nbytes`` counts each input read
    once and each output written once, ``flops`` the f32 operations.
    ``flat`` turns a kernel's, twin's or library's result into one tensor
    for the comparison (default: it is one)."""
    import torch

    flat = flat or (lambda t: t)
    y = flat(kernel())
    ref = flat(plain())
    torch.cuda.synchronize()
    err = float((y - ref).abs().max()) if y.numel() else 0.0
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    ok = bool(torch.isfinite(y).all()) and err <= bound * max(scale, 1e-30)
    ms = cuda_ms(kernel, flush=flush)
    plain_ms = cuda_ms(plain, flush=flush)
    library_ms = library_err = None
    if library is not None:
        lib_y = flat(library()).reshape(ref.shape).float()
        torch.cuda.synchronize()
        library_err = (float((lib_y - ref).abs().max()) if ref.numel()
                       else 0.0)
        del lib_y
        library_ms = cuda_ms(library, flush=flush)
    bw, peak_flops, _ = PEAK
    bytes_ms, ops_ms = nbytes / bw * 1e3, flops / peak_flops * 1e3
    row = dict(name=name, max_abs_err=err, max_abs_ref=scale,
               rel_err=err / max(scale, 1e-30), ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, library_err=library_err,
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               bound_us=max(bytes_ms, ops_ms) * 1e3, bytes=nbytes,
               gb_per_s=nbytes / ms / 1e6)
    print("check " + " ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in row.items()), flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its twin "
                             f"(max|Δ| {err:.3e} > {bound:g}·{scale:.3e})")
    return row


def _vec(rng, n, dev):
    import torch

    return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)


def library_csr(indptr, indices, vals, shape):
    """A ``torch.sparse_csr_tensor`` (int64 indices, f32 values) for the
    ``torch.sparse.mm`` yardstick; built apart, never handed to the
    port."""
    import torch

    return torch.sparse_csr_tensor(indptr.long(), indices.long(),
                                   vals.float(), size=shape)


def library_spmv(csr, x):
    """One ``torch.sparse.mm`` call: y = A·x as an (n, 1) product."""
    import torch

    xm = x[:, None]
    return lambda: torch.sparse.mm(csr, xm)


def library_addmm(csr, x, v, alpha):
    """One ``torch.addmm`` call: v + alpha·A·x as an (n, 1) product (the
    residual mode with v = b and alpha = −1, correct with alpha = 1)."""
    import torch

    xm, vm = x[:, None], v[:, None]
    return lambda: torch.addmm(vm, csr, xm, alpha=alpha)


def sms() -> int:
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


def expect_path(mod, name, call, vector):
    """One wrapper call launches the kernel of ``mod`` (``dia_spmv`` or
    ``remote_halo``) once, on the vector path iff ``vector`` (the launch
    counters say which)."""
    before = mod.launches, mod.scalar_launches
    call()
    got = (mod.launches - before[0], mod.scalar_launches - before[1])
    if got != (1, int(not vector)):
        raise AssertionError(f"{name}: launches {got}, expected "
                             f"{'the vector' if vector else 'the scalar'} "
                             "path once")


def halo_scalar_check(name, srcs, nl, nr, flush):
    """The window kernel's scalar path forced through its C entry point on
    vector-path operands: bitwise the twin, both paths timed; a ``paths``
    line. These launches are comparisons, not main-path launches."""
    import torch

    from omp_amg_tpu_torch import _build
    from omp_amg_tpu_torch.ops import remote_halo

    lib = _build.cuda_kernels()
    d, n = len(srcs), srcs[0].numel()
    out = torch.empty((d, nl + n + nr), device="cuda")
    table = remote_halo._Table(*(t.data_ptr() for t in srcs))

    def call(vec):
        rc = lib.remote_halo_window_launch(
            d, n, nl, nr, out.shape[1], vec, table, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: remote_halo launch failed: {rc}")
    call(0)
    want = remote_halo.remote_halo_window_plain(srcs, nl, nr)
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise AssertionError(f"{name}: the forced scalar path differs from "
                             "the twin")
    print(f"check {name}:forced-scalar max_abs_err="
          f"{float((out - want).abs().max()):.6g} (bitwise the twin)",
          flush=True)
    times = {p: cuda_ms(lambda: call(vec), flush=flush)
             for p, vec in (("vector", 1), ("scalar", 0))}
    print(f"paths {name} " + " ".join(f"{k}_us={v * 1e3:.2f}"
                                       for k, v in times.items())
          + " taken=vector", flush=True)


def enqueue_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` calls without a
    sync: what the host spends enqueuing it (the device runs behind)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def dia_path_times(name, a, x, x_base, flush):
    """spmv through each path of ``dia_spmv``'s C entry point where the
    operands allow it (the wrapper takes one by its rule); a ``paths``
    line. These launches are comparisons, not main-path launches."""
    import torch

    from omp_amg_tpu_torch import _build
    from omp_amg_tpu_torch.ops import dia_spmv

    lib = _build.cuda_kernels()
    out = torch.empty(a.n_rows, device="cuda")

    def call(vec):
        rc = lib.dia_spmv_launch(
            0, int(a.data.dtype == torch.bfloat16), vec, a.n_rows,
            len(a.offsets), a.offsets_i32, a.data.data_ptr(),
            x.data_ptr(), x_base, x.numel(), None, None, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: dia_spmv launch failed: {rc}")
    fits = dia_spmv.vector_path(a, x, x_base, (), 0)
    times = {("vector" if vec else "scalar"): cuda_ms(lambda: call(vec),
                                                      flush=flush)
             for vec in ((1, 0) if fits else (0,))}
    taken = dia_spmv.vector_path(a, x, x_base, (), sms())
    print(f"paths {name} " + " ".join(f"{k}_us={v * 1e3:.2f}"
                                       for k, v in times.items())
          + f" taken={'vector' if taken else 'scalar'}", flush=True)


def csr_width_times(name, a, x, flush):
    """spmv of the f32 operator ``a`` at every lane width V through
    ``csr_spmv``'s C entry point (the wrapper passes ``a.vec``); a
    ``vsweep`` line. These launches are comparisons, not main-path
    launches."""
    import torch

    from omp_amg_tpu_torch import _build

    lib = _build.cuda_kernels()
    out = torch.empty(a.n_rows, device="cuda")

    def call(vec):
        rc = lib.csr_spmv_launch(
            0, 0, vec, a.n_rows, a.indptr.data_ptr(), a.indices.data_ptr(),
            a.vals.data_ptr(), x.data_ptr(), None, None, None,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: csr_spmv launch failed: {rc}")
    times = {vec: cuda_ms(lambda: call(vec), flush=flush)
             for vec in (1, 2, 4, 8, 16, 32)}
    print(f"vsweep {name} rows={a.n_rows} nnz={a.nnz} "
          f"mean={a.nnz / a.n_rows:.2f} rule_V={a.vec} "
          + " ".join(f"V{vec}_us={t * 1e3:.2f}" for vec, t in times.items()),
          flush=True)


def dia_checks(tag, a, s, rng, flush, dtypes):
    """All three ``dia_spmv`` modes × ``dtypes`` on the banded operator
    ``a`` (s: its Jacobi scale)."""
    import torch

    from omp_amg_tpu_torch.ops import dia_spmv
    from omp_amg_tpu_torch.sparse.formats import Dia, dia_to_scipy

    n = a.n_rows
    x, b = _vec(rng, n, a.data.device), _vec(rng, n, a.data.device)
    # the same banded operator as f32 CSR, for the torch.sparse.mm yardstick
    host = dia_to_scipy(Dia(data=a.data.float().cpu().numpy(),
                            offsets=a.offsets))
    csr = library_csr(*(torch.from_numpy(t).cuda() for t in (
        host.indptr, host.indices, host.data)), host.shape)
    library = {"spmv": library_spmv(csr, x),
               "residual": library_addmm(csr, x, b, -1)}
    flops = 2 * host.nnz
    del host
    rows = []
    for dt in dtypes:
        ad = Dia(data=a.data.to(dt).contiguous(), offsets=a.offsets,
                 dims=a.dims)
        vt = "bf16" if dt == torch.bfloat16 else "f32"
        dia_path_times(f"dia_spmv:{tag}:{vt}", ad, x, 0, flush)
        vb = ad.data.numel() * ad.data.element_size() + 8 * n
        cases = {
            "spmv": (lambda: dia_spmv.spmv(ad, x),
                     lambda: dia_spmv.dia_spmv_plain(ad, x), vb),
            "residual": (lambda: dia_spmv.residual(ad, x, b),
                         lambda: dia_spmv.dia_spmv_plain(ad, x, "residual",
                                                         b), vb + 4 * n),
            "jacobi": (lambda: dia_spmv.jacobi(ad, x, b, s),
                       lambda: dia_spmv.dia_spmv_plain(ad, x, "jacobi", b, s),
                       vb + 8 * n),
        }
        for mode, (kern, plain, nbytes) in cases.items():
            name = f"dia_spmv:{tag}:{vt}:{mode}:n={n}:ndiag={len(a.offsets)}"
            expect_path(dia_spmv, name, kern, dia_spmv.vector_path(
                ad, x, 0, {"spmv": (), "residual": (b,),
                           "jacobi": (b, s)}[mode], sms()))
            rows.append(compare(name, kern, plain, DIA_BOUND, nbytes, flush,
                                library=library.get(mode), flops=flops))
    return rows


def pmis_kernel_checks(hier, rng, flush):
    """Every kernel × mode × value type on the PMIS hierarchy's operators."""
    import torch

    from omp_amg_tpu_torch.ops import csr_spmv
    from omp_amg_tpu_torch.sparse.formats import Csr, Dia

    dev = hier.device
    lv0 = hier.levels[0]
    if not isinstance(lv0.a, Dia):
        raise AssertionError("fine level is not banded")
    rows = {"dia_spmv": dia_checks("L0-A", lv0.a, lv0.s, rng, flush,
                                   (torch.float32, torch.bfloat16)),
            "csr_spmv": []}
    for l, lv in enumerate(hier.levels):
        ops = [("P", lv.p), ("R", lv.r)]
        if isinstance(lv.a, Csr):
            ops.insert(0, ("A", lv.a))
        for opname, op in ops:
            m, k = op.shape
            x, b, v = _vec(rng, k, dev), _vec(rng, m, dev), _vec(rng, m, dev)
            s = lv.s if opname == "A" else None
            csr = library_csr(op.indptr, op.indices, op.vals, op.shape)
            library = {"spmv": library_spmv(csr, x),
                       "residual": library_addmm(csr, x, b, -1),
                       "correct": library_addmm(csr, x, v, 1)}
            if m >= 50_000:
                csr_width_times(f"csr_spmv:L{l}-{opname}:f32:spmv", op, x,
                                flush)
            for dt in (torch.float32, torch.bfloat16):
                a = Csr(indptr=op.indptr, indices=op.indices,
                        vals=op.vals.to(dt).contiguous(), n_cols=op.n_cols)
                tag = "bf16" if dt == torch.bfloat16 else "f32"
                cb = (a.nnz * (4 + a.vals.element_size()) + 8 * (m + 1)
                      + 4 * k + 4 * m)
                cases = {
                    "spmv": (lambda: csr_spmv.spmv(a, x),
                             lambda: csr_spmv.csr_spmv_plain(a, x), cb),
                    "residual": (lambda: csr_spmv.residual(a, x, b),
                                 lambda: csr_spmv.csr_spmv_plain(
                                     a, x, "residual", b=b), cb + 4 * m),
                    "correct": (lambda: csr_spmv.correct(a, x, v),
                                lambda: csr_spmv.csr_spmv_plain(
                                    a, x, "correct", v=v), cb + 4 * m),
                }
                if s is not None:
                    cases["jacobi"] = (
                        lambda: csr_spmv.jacobi(a, x, b, s),
                        lambda: csr_spmv.csr_spmv_plain(a, x, "jacobi", b=b,
                                                        s=s), cb + 8 * m)
                for mode, (kern, plain, nbytes) in cases.items():
                    rows["csr_spmv"].append(compare(
                        f"csr_spmv:L{l}-{opname}:{tag}:{mode}:"
                        f"rows={m}:nnz={a.nnz}:V={a.vec}", kern, plain,
                        CSR_BOUND, nbytes, flush,
                        library=library.get(mode), flops=2 * a.nnz))
            del csr, library
    return rows


def const_zchunk_times(name, cd, x, flush):
    """spmv of the ``ConstDia`` ``cd`` at several z-chunk lengths through
    ``const_stencil``'s C entry point (the wrapper passes ``plan``'s); a
    ``zsweep`` line. These launches are comparisons, not main-path
    launches."""
    import torch

    from omp_amg_tpu_torch import _build
    from omp_amg_tpu_torch.ops import const_stencil as cs

    lib = _build.cuda_kernels()
    out = torch.empty(cd.n_rows, device="cuda")
    taps, coeffs = cd.operand
    nz, ny, nx = cd.dims

    def call(zchunk):
        rc = lib.const_stencil_launch(
            0, nz, ny, nx, zchunk, len(coeffs), taps.ctypes.data,
            coeffs.ctypes.data, 0.0, x.data_ptr(), None, None,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: const_stencil launch failed: {rc}")
    _, _, rule, blocks = cs.plan(cd.dims, sms())
    zchunks = sorted({z for z in (1, 2, 4, 8, 16, 32, 64) if z <= nz}
                     | {rule})
    times = {z: cuda_ms(lambda: call(z), flush=flush) for z in zchunks}
    print(f"zsweep {name} rule_zchunk={rule} blocks={blocks} "
          + " ".join(f"z{z}_us={t * 1e3:.2f}" for z, t in times.items()),
          flush=True)


def const_checks(tag, a, rng, flush):
    """All five ``const_stencil`` modes on the host operator ``a`` (a
    masked-constant 3D stencil), on the card, against the twin, and the
    ``zsweep`` line of spmv."""
    import torch

    from omp_amg_tpu_torch.ops import const_stencil as cs
    from omp_amg_tpu_torch.sparse.formats import Dia, to_const_dia

    cd = to_const_dia(Dia(data=a.data.astype(np.float32), offsets=a.offsets,
                          dims=a.dims), device="cuda")
    if cd is None:
        raise AssertionError(f"{tag}: not a masked-constant stencil")
    n = cd.n_rows
    x, b, p = (_vec(rng, n, cd.device) for _ in range(3))
    s = float(np.float32(0.137))
    plain = cs.const_stencil_plain
    # F.conv3d with zero padding (cross-correlation: weight[dz+1, dy+1,
    # dx+1] multiplies x[z+dz, y+dy, x+dx]); TF32 is off (main())
    weight = torch.zeros((1, 1, 3, 3, 3), dtype=torch.float32,
                         device=cd.device)
    for (dz, dy, dx), c in zip(cd.taps, cd.coeffs):
        weight[0, 0, dz + 1, dy + 1, dx + 1] = c
    x5 = x.view(1, 1, *cd.dims)

    def conv():
        return torch.nn.functional.conv3d(x5, weight, padding=1)
    flops = 2 * len(cd.operand[1]) * n
    cases = {
        "spmv": (lambda: cs.spmv(cd, x), lambda: plain(cd, x), 8 * n),
        "residual": (lambda: cs.residual(cd, x, b),
                     lambda: plain(cd, x, "residual", b=b), 12 * n),
        "jacobi": (lambda: cs.jacobi(cd, x, b, s),
                   lambda: plain(cd, x, "jacobi", b=b, s=s), 12 * n),
        "zjr": (lambda: cs.presmooth_residual(cd, b, s),
                lambda: plain(cd, b, "zjr", s=s), 8 * n),
        "cja": (lambda: cs.correct_jacobi(cd, b, p, s),
                lambda: plain(cd, b, "cja", p=p, s=s), 12 * n),
    }
    const_zchunk_times(f"const_stencil:{tag}:spmv", cd, x, flush)
    return [compare(f"const_stencil:{tag}:{mode}:n={n}:taps={len(cd.taps)}",
                    kern, pl, CONST_BOUND, nbytes, flush,
                    library=conv if mode == "spmv" else None, flops=flops)
            for mode, (kern, pl, nbytes) in cases.items()]


def drive(label, a, params, grid, counters, vcycle=None, solve_kw=None,
          **kw):
    """Drive one main path through the user's entry points: counters set to
    0 just before, read just after; certified and scipy f64 residuals
    checked; then a warm solve and the cycle time (``vcycle(solver, r)``,
    default the single-device ``amg.vcycle``). ``kw`` goes to
    ``AMGSolver`` (a mesh, its transport), ``solve_kw`` to both solves (the
    PCG variant). Returns (solver, launches, run): run holds setup_s,
    warm_solve_s, x and the solve's ``last_info``."""
    import torch

    import omp_amg_tpu_torch as amg

    solve_kw = solve_kw or {}
    b = amg.default_rhs(a, seed=SEED)
    for mod in counters.values():
        mod.launches = 0
        if hasattr(mod, "scalar_launches"):
            mod.scalar_launches = 0
    t0 = time.perf_counter()
    solver = amg.AMGSolver(a, params, grid=grid, device="cuda", **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = solver.solve(b, tol=1e-8, **solve_kw)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in counters.items()}
    scalar = {name: mod.scalar_launches for name, mod in counters.items()
              if hasattr(mod, "scalar_launches")}
    info = dict(solver.last_info)
    b64 = b.numpy().astype(np.float64)
    host_rel = float(np.linalg.norm(b64 - amg.dia_to_scipy(a) @ x)
                     / np.linalg.norm(b64))
    forms = [type(lv.a).__name__ for lv in solver.hierarchy.levels]
    print(f"{label} sizes={solver.stats()['sizes']} forms={forms} "
          f"setup_s={setup_s:.3f} solve_s={solve_s:.3f} "
          f"inner_iters={info['inner_iters']} outer={info['outer_iters']} "
          f"certified_rel={info['rel_residual']:.3e} "
          f"scipy_rel={host_rel:.3e} residual={info['residual']} "
          f"launches={launches} of_them_scalar_path={scalar}", flush=True)
    if not (x.shape == (a.n_rows,) and np.isfinite(x).all()):
        raise AssertionError(f"{label}: solution has the wrong shape or is "
                             "not finite")
    if info["rel_residual"] > 1e-8:
        raise AssertionError(f"{label}: certified rel "
                             f"{info['rel_residual']:.3e} > 1e-8")
    if host_rel > 2e-8:
        raise AssertionError(f"{label}: scipy f64 cross-check "
                             f"{host_rel:.3e} > 2e-8")
    t0 = time.perf_counter()
    solver.solve(b, tol=1e-8, **solve_kw)
    torch.cuda.synchronize()
    warm_solve_s = time.perf_counter() - t0
    r = b.to("cuda")
    if vcycle is None:
        def vcycle(solver, r):
            return amg.vcycle(solver.hierarchy, r)
    vcycle_ms = cuda_ms(lambda: vcycle(solver, r))
    print(f"{label} warm_solve_s={warm_solve_s:.3f} "
          f"vcycle_ms={vcycle_ms:.4f}", flush=True)
    return solver, launches, dict(setup_s=setup_s, info=info, x=x,
                                  warm_solve_s=warm_solve_s,
                                  vcycle_ms=vcycle_ms, scalar=scalar,
                                  scipy_rel=host_rel)


def expect_launches(label, launches, used):
    """Every kernel in ``used`` launched, every other one not."""
    for name, count in launches.items():
        if (count > 0) != (name in used):
            raise AssertionError(f"{label}: {name} launched {count} times; "
                                 f"expected {'>0' if name in used else 0}")


def parity(label, a, params, grid, record=None, shards=None, solve_kw=None,
           **kw):
    """The GPU solve's inner and outer counts against the port's own CPU
    solve; a difference prints both residual histories and fails. With
    ``shards``, both run on a ``ShardMesh`` of that many shards (``kw``:
    more ``AMGSolver`` arguments; ``solve_kw``: ``solve`` arguments, for
    both)."""
    import omp_amg_tpu_torch as amg

    b = amg.default_rhs(a, seed=SEED)
    runs = {}
    for dev in ("cuda", "cpu"):
        if shards is not None:
            kw["mesh"] = amg.ShardMesh(shards, dev)
        s = amg.AMGSolver(a, params, grid=grid, device=dev, **kw)
        s.solve(b, tol=1e-8, **(solve_kw or {}))
        runs[dev] = s.last_info
    g, c = runs["cuda"], runs["cpu"]
    rec = "" if record is None else (
        f" | TPU record (bench_details.json) inner={record[0]} "
        f"outer={record[1]}")
    print(f"parity {label} gpu inner={g['inner_iters']} "
          f"outer={g['outer_iters']} rel={g['rel_residual']:.3e} "
          f"residual={g['residual']} | cpu inner={c['inner_iters']} "
          f"outer={c['outer_iters']} rel={c['rel_residual']:.3e} "
          f"residual={c['residual']}{rec}", flush=True)
    if (g["inner_iters"], g["outer_iters"]) != (c["inner_iters"],
                                                c["outer_iters"]):
        for dev, run in runs.items():
            for k, hist in enumerate(run["residual_histories"]):
                print(f"parity history {label} {dev} outer={k}: "
                      + " ".join(f"{h:.6e}" for h in hist))
        raise AssertionError(f"{label}: GPU and CPU iteration counts differ "
                             "(histories above: a difference of one must be "
                             "traced to reduction order before it is "
                             "accepted)")


def spmm_bytes(a, c) -> int:
    """Bytes ``spmm_panel`` must move: A's nonzeros and indptr, X and U
    once each."""
    return a.nnz * 8 + (a.n_rows + 1) * 8 + a.n_cols * c * 4 + a.n_rows * c * 4


def spmm_instance_times(name, op, x, flush):
    """U = A·X through ``panel_spmm``'s C entry point on the general
    instance (q = 0: a warp per row, 4-byte loads, one nonzero at a time)
    beside the wrapper's instance; a ``psweep`` line. The general instance
    must give the kernel's bits. These launches are comparisons, not
    main-path launches."""
    import torch

    from omp_amg_tpu_torch import _build
    from omp_amg_tpu_torch.ops import panel_spmm as ps

    lib = _build.cuda_kernels()
    c = x.shape[1]
    out = torch.empty((op.n_rows, c), device="cuda")

    def call(q):
        rc = lib.panel_spmm_launch(
            op.n_rows, c, q, op.indptr.data_ptr(), op.indices.data_ptr(),
            op.vals.data_ptr(), x.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: panel_spmm launch failed: {rc}")
    q = ps.lane_plan(c)[0]
    call(0)
    torch.cuda.synchronize()
    if not torch.equal(out, ps.spmm_panel(op, x)):
        raise AssertionError(f"{name}: the general instance differs from "
                             "the kernel")
    times = {f"q{q}": cuda_ms(lambda: call(q), flush=flush),
             "q0": cuda_ms(lambda: call(0), flush=flush)}
    print(f"psweep {name} " + " ".join(
        f"{k}_us={t * 1e3:.2f}" for k, t in times.items()), flush=True)


def probe_kernel_checks(l, probe, flush):
    """``panel_spmm`` on A·PV and R·U of the first colour group and
    ``extract_lanes`` on the whole W of level ``l``'s probe, each against
    its twin on the same CUDA tensors, with its library yardstick."""
    import torch

    from omp_amg_tpu_torch.ops import extract_lanes as ex
    from omp_amg_tpu_torch.ops import panel_spmm as ps
    from omp_amg_tpu_torch.ops import probe_rap as pr

    rows = {"panel_spmm": [], "extract_lanes": []}
    c0, width = probe.groups[0]
    x = pr.panel_pv(probe, c0, width)
    for opname, op in (("A·PV", probe.a), ("R·U", probe.r)):
        csr = library_csr(op.indptr, op.indices, op.vals, op.shape)
        name = f"panel_spmm:L{l}-{opname}:rows={op.n_rows}:nnz={op.nnz}:" \
               f"C={width}"
        spmm_instance_times(name, op, x, flush)
        rows["panel_spmm"].append(compare(
            name, lambda: ps.spmm_panel(op, x),
            lambda: ps.spmm_panel_plain(op, x), PROBE_BOUND,
            spmm_bytes(op, width), flush,
            library=lambda: torch.sparse.mm(csr, x),
            flops=2 * op.nnz * width))
        x = ps.spmm_panel(op, x)
        del csr
    parts = [x]
    for c0, width in probe.groups[1:]:
        parts.append(ps.spmm_panel(probe.r, ps.spmm_panel(
            probe.a, pr.panel_pv(probe, c0, width))))
    w = torch.cat(parts, dim=1)
    idx = probe.ac_cidx
    idx64 = idx.long()
    real = int(probe.ac_mask.sum())
    rows["extract_lanes"].append(compare(
        f"extract_lanes:L{l}:rows={idx.shape[0]}:slots={idx.shape[1]}:"
        f"W={w.shape[1]}", lambda: ex.extract_lanes(w, idx),
        lambda: ex.extract_lanes_plain(w, idx), PROBE_BOUND,
        idx.numel() * 8 + real * 4, flush,
        library=lambda: torch.gather(w, 1, idx64)))
    return rows


def probe_setup_checks(a, params, flush):
    """Phase 5a: the PMIS setup with ``rap="probe"`` and ``keep_host``; per
    level the host Galerkin product, the colouring (host seconds) and the
    device numeric phase (CUDA events), its A_c within RAP_BOUND of the
    host product and equal to the setup's own values; kernel checks on
    levels 0 and 1. Returns (host record, kernel rows)."""
    import torch

    import omp_amg_tpu_torch as amg
    from omp_amg_tpu_torch.ops import probe_rap as pr
    from omp_amg_tpu_torch.ops.rap import galerkin_product
    from omp_amg_tpu_torch.sparse.formats import ell_planes_from_scipy

    t0 = time.perf_counter()
    _, host = amg.amg_setup(a, params, device="cuda", keep_host=True)
    torch.cuda.synchronize()
    print(f"probe setup (keep_host) n={a.n_rows} "
          f"setup_s={time.perf_counter() - t0:.3f}", flush=True)
    rows = {"panel_spmm": [], "extract_lanes": []}
    for l, p_sp in enumerate(host.p):
        a_sp = host.ops[l]
        t0 = time.perf_counter()
        ac = galerkin_product(a_sp, p_sp)
        host_rap_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        coloring = pr.d2_color(ac)
        color_s = time.perf_counter() - t0
        line = (f"probe L{l} rows={a_sp.shape[0]} nnz_A={a_sp.nnz} "
                f"nnz_Ac={ac.nnz} host_galerkin_s={host_rap_s:.4f} "
                f"d2_color_s={color_s:.4f}")
        if coloring is None:
            print(f"{line} colours>256: host values", flush=True)
            continue
        probe, _ = pr.build_rap_probe(a_sp, p_sp, ac, device="cuda")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        vals = pr.rap_probe_numeric(probe)
        end.record()
        torch.cuda.synchronize()
        numeric_ms = start.elapsed_time(end)
        want = ell_planes_from_scipy(ac, dtype=np.float64)[1]
        got = vals.double().cpu().numpy()
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        print(f"{line} colours={probe.n_colors} groups={len(probe.groups)} "
              f"widths={[w for _, w in probe.groups]} "
              f"numeric_ms={numeric_ms:.3f} max_abs_err={err:.3e} "
              f"rel_err={err / scale:.3e}", flush=True)
        if err > RAP_BOUND * scale:
            raise AssertionError(f"probe L{l}: A_c off the host product by "
                                 f"{err:.3e} > {RAP_BOUND:g}·{scale:.3e}")
        setup_vals = got[probe.ac_mask.cpu().numpy() != 0]
        if not np.array_equal(setup_vals, host.ops[l + 1].data):
            raise AssertionError(f"probe L{l}: the setup's A_c values are "
                                 "not this numeric phase's")
        if l < 2:
            for name, more in probe_kernel_checks(l, probe, flush).items():
                rows[name] += more
        del probe, vals
    return host, rows


def rap_bench(n):
    """Phase 5c: ``bench.py``'s numeric-phase measurement on the card (its
    lines 515-542): level 0 of the PMIS ``poisson3d_7pt(n)`` hierarchy,
    warm, CUDA events, 5 calls; and the host Galerkin product of the same
    level on this machine."""
    import omp_amg_tpu_torch as amg
    from omp_amg_tpu_torch.ops import probe_rap as pr
    from omp_amg_tpu_torch.ops.rap import galerkin_product

    a = amg.poisson3d_7pt(n)
    _, host = amg.amg_setup(a, amg.AMGParams(coarsening="pmis"),
                            device="cuda", keep_host=True)
    a0, p0 = host.ops[0], host.p[0]
    t0 = time.perf_counter()
    galerkin_product(a0, p0)
    host_s = time.perf_counter() - t0
    probe, _ = pr.build_rap_probe(a0, p0, device="cuda")
    if probe is None:
        raise AssertionError(f"{n}^3 L0: colouring above the cap")
    ms = cuda_ms(lambda: pr.rap_probe_numeric(probe), reps=5, warm=1)
    print(f"rap_bench n={n}^3 L0 nnz_A={a0.nnz} colours={probe.n_colors} "
          f"rap_probe_ms={ms:.4f} "
          f"rap_probe_gnnz_per_s={a0.nnz / ms / 1e6:.4f} "
          f"host_galerkin_s={host_s:.4f} "
          f"host_gnnz_per_s={a0.nnz / host_s / 1e9:.4f}", flush=True)


def profile_solve(label, solver, b, top=8, **solve_kw):
    """One warm certified solve (``solve_kw``: more ``solve`` arguments)
    under ``torch.profiler``: wall seconds, device busy milliseconds (the
    profiler's "Self CUDA time total": the self device time of the device
    events) and their share of the wall, and the ``top`` device items by
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.solve(b, tol=1e-8, **solve_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    copy_ms = sum(e.self_device_time_total for e in dev
                  if "Memcpy" in e.key) / 1e3
    items = sorted(dev, key=lambda e: -e.self_device_time_total)[:top]
    dtoh = sum(e.count for e in dev if "DtoH" in e.key)
    print(f"profile {label} wall_s={wall:.4f} device_busy_ms={busy_ms:.3f} "
          f"busy_share={busy_ms / 1e3 / wall:.4f} memcpy_ms={copy_ms:.3f} "
          f"dtoh_copies={dtoh} device_items={sum(e.count for e in dev)}",
          flush=True)
    for e in items + [e for e in dev if e not in items and any(
            k in e.key for k in ("remote_halo_window_kernel",
                                 "dia_spmv_kernel", "csr_spmv_kernel",
                                 "CatArray", "FillFunctor"))]:
        print(f"profile {label} item ms={e.self_device_time_total / 1e3:.3f}"
              f" count={e.count} us_each="
              f"{e.self_device_time_total / max(e.count, 1):.2f} "
              f"name={e.key[:90]}", flush=True)


def sharded_path(n, counters, flush, rng):
    """Phase 10: the z-slab distributed path (module docstring); returns
    (launches of its main-path run, that run, kernel rows)."""
    import torch

    import omp_amg_tpu_torch as amg
    from omp_amg_tpu_torch.ops import dia_spmv
    from omp_amg_tpu_torch.ops import remote_halo as rh
    from omp_amg_tpu_torch.parallel.dist import dist_vcycle
    from omp_amg_tpu_torch.parallel.slab import (
        _exchange_planes, _exchange_planes_remote,
    )

    a = amg.poisson3d_7pt(n)
    grid = (n,) * 3
    params = amg.AMGParams()

    def vcycle(solver, r):
        return dist_vcycle(solver.hierarchy, solver.mesh.shard(r))

    # 10a: the main path, remote transport
    solver, launches, run = drive(
        f"sharded d={SHARDS} remote n={n}^3", a, params, grid, counters,
        vcycle=vcycle, mesh=amg.ShardMesh(SHARDS, "cuda"),
        transport="remote")
    print(f"sharded d={SHARDS} stats={solver.stats()}", flush=True)
    expect_launches("sharded", launches, ("dia_spmv", "remote_halo"))
    info = run["info"]
    runs = {"remote": run}
    for label, mesh, transport in (
            ("ppermute", amg.ShardMesh(SHARDS, "cuda"), "ppermute"),
            ("1-shard", amg.ShardMesh(1, "cuda"), "remote")):
        _, _, runs[label] = drive(
            f"sharded d={mesh.size} {transport} n={n}^3", a, params, grid,
            counters, vcycle=vcycle, mesh=mesh, transport=transport)
    pp = runs["ppermute"]
    if not np.array_equal(pp["x"], run["x"]) or (
            pp["info"]["inner_iters"], pp["info"]["outer_iters"]) != (
            info["inner_iters"], info["outer_iters"]):
        raise AssertionError("sharded: the ppermute solve differs from the "
                             "remote one")
    print(f"sharded ppermute == remote: x bitwise equal, inner "
          f"{pp['info']['inner_iters']} outer {pp['info']['outer_iters']}",
          flush=True)
    one = runs["1-shard"]["info"]
    diffs = [abs(u - v) for u, v in zip(one["inner_iters"],
                                         info["inner_iters"])]
    print(f"sharded partition invariance: d={SHARDS} inner "
          f"{info['inner_iters']} outer {info['outer_iters']} | d=1 inner "
          f"{one['inner_iters']} outer {one['outer_iters']}", flush=True)
    if any(diffs) or one["outer_iters"] != info["outer_iters"]:
        for tag, inf in ((f"d={SHARDS}", info), ("d=1", one)):
            for k, hist in enumerate(inf["residual_histories"]):
                print(f"history sharded {tag} outer={k}: "
                      + " ".join(f"{h:.6e}" for h in hist), flush=True)
        if max(diffs, default=0) > 1 or one["outer_iters"] != \
                info["outer_iters"]:
            raise AssertionError("sharded: 1-shard counts differ by more "
                                 "than one inner iteration")
    b = amg.default_rhs(a, seed=SEED)
    profile_solve(f"sharded d={SHARDS} remote n={n}^3", solver, b)

    # 10b: the window kernel at the main path's shapes
    rows = {"remote_halo": [], "dia_spmv": []}
    dh = solver.hierarchy
    shapes = [(f"L{l}", SHARDS, lv.a.data[0].shape[1], lv.a.plane, lv.a.hl,
               lv.a.hr) for l, lv in enumerate(dh.levels) if lv.sharded]
    lv0 = dh.levels[0].a
    shapes.append(("L0", 2 * SHARDS, n ** 3 // (2 * SHARDS), lv0.plane,
                   lv0.hl, lv0.hr))
    for tag, d, n_loc, plane, hl, hr in shapes:
        srcs = [_vec(rng, n_loc, "cuda") for _ in range(d)]
        nl, nr = hl * plane, hr * plane
        vec = rh.vector_path(srcs, n_loc, nl, nr)
        path = "vector" if vec else "scalar"
        name = (f"remote_halo:{tag}:d={d}:n_loc={n_loc}:nl={nl}:nr={nr}:"
                f"path={path}")
        window = (lambda srcs=srcs, nl=nl, nr=nr:
                  rh.remote_halo_window(srcs, nl, nr))
        expect_path(rh, name, window, vec)
        # the library yardstick: one torch.cat of the windows' parts, the
        # two zero strips made beforehand
        parts = []
        for i, x in enumerate(srcs):
            parts += [srcs[i - 1][n_loc - nl:] if i else x.new_zeros(nl), x,
                      srcs[i + 1][:nr] if i < d - 1 else x.new_zeros(nr)]
        # bytes: every window written, every part read but the zero strips
        nbytes = 4 * d * (nl + n_loc + nr) + 4 * (d * n_loc
                                                  + (d - 1) * (nl + nr))
        row = compare(name, window,
                      lambda: rh.remote_halo_window_plain(srcs, nl, nr),
                      HALO_BOUND, nbytes, flush,
                      library=lambda parts=parts: torch.cat(parts),
                      flat=lambda w: w.reshape(-1))
        rows["remote_halo"].append(row)
        del parts
        got = _exchange_planes_remote(srcs, plane, hl, hr)
        want = _exchange_planes(srcs, plane, hl, hr)
        torch.cuda.synchronize()
        if not all(torch.equal(u, v) for u, v in zip(got, want)) or \
                got[0][:nl].any() or got[-1][got[-1].numel() - nr:].any():
            raise AssertionError(f"remote_halo {tag} d={d}: the windows "
                                 "differ from the plain exchange")
        print(f"check remote_halo:{tag}:d={d} windows == plain exchange, "
              f"global ends zero, path={path}", flush=True)
        del got, want
        remote = (lambda srcs=srcs, plane=plane, hl=hl, hr=hr:
                  _exchange_planes_remote(srcs, plane, hl, hr))
        plain = (lambda srcs=srcs, plane=plane, hl=hl, hr=hr:
                 _exchange_planes(srcs, plane, hl, hr))
        print(f"halo {tag} d={d} window_us={row['ms'] * 1e3:.2f} "
              f"exchange_remote_us={cuda_ms(remote, flush=flush) * 1e3:.2f} "
              f"ppermute_us={cuda_ms(plain, flush=flush) * 1e3:.2f} "
              f"(a sequence of {d + 2} calls: {d} torch.cat, 2 new_zeros) "
              f"bound_us={row['bound_us']:.3f} host_enqueue_us_remote="
              f"{enqueue_us(remote):.2f} host_enqueue_us_ppermute="
              f"{enqueue_us(plain):.2f} (per exchange, 1000 calls, no sync)",
              flush=True)
        if tag == "L0" and d == SHARDS:
            halo_scalar_check(name, srcs, nl, nr, flush)
    # dia_spmv's x-window mode on shard 1 of L0 (its exchanged window)
    lv = dh.levels[0]
    xs = [_vec(rng, lv0.data[0].shape[1], "cuda") for _ in range(SHARDS)]
    bs = [_vec(rng, lv0.data[0].shape[1], "cuda") for _ in range(SHARDS)]
    win = _exchange_planes(xs, lv0.plane, lv0.hl, lv0.hr)[1]
    base = lv0.hl * lv0.plane
    blk, b1, s1 = lv0.blocks[1], bs[1], lv.s[1]
    n_loc = blk.n_rows
    vb = blk.data.numel() * blk.data.element_size() + 4 * win.numel() \
        + 4 * n_loc
    # the shard's band as a CSR over its x window, for the library calls
    offs = torch.tensor(blk.offsets, device="cuda")
    cols = base + torch.arange(n_loc, device="cuda") + offs[:, None]
    keep = (cols >= 0) & (cols < win.numel()) & (blk.data != 0)
    rows_ = torch.arange(n_loc, device="cuda").expand_as(cols)
    band = torch.sparse_coo_tensor(
        torch.stack([rows_[keep], cols[keep]]), blk.data.float()[keep],
        (n_loc, win.numel())).coalesce().to_sparse_csr()
    del offs, cols, keep, rows_
    library = {"spmv": library_spmv(band, win),
               "residual": library_addmm(band, win, b1, -1)}
    dia_path_times(f"dia_spmv:SH-L0-shard1:window", blk, win, base, flush)
    cases = {
        "spmv": (lambda: dia_spmv.spmv(blk, win, x_base=base),
                 lambda: dia_spmv.dia_spmv_plain(blk, win, x_base=base), vb),
        "residual": (lambda: dia_spmv.residual(blk, win, b1, x_base=base),
                     lambda: dia_spmv.dia_spmv_plain(blk, win, "residual",
                                                     b1, x_base=base),
                     vb + 4 * n_loc),
        "jacobi": (lambda: dia_spmv.jacobi(blk, win, b1, s1, x_base=base),
                   lambda: dia_spmv.dia_spmv_plain(blk, win, "jacobi", b1,
                                                   s1, x_base=base),
                   vb + 8 * n_loc),
    }
    vt = "bf16" if blk.data.dtype == torch.bfloat16 else "f32"
    for mode, (kern, plain, nbytes) in cases.items():
        name = (f"dia_spmv:SH-L0-shard1:{vt}:window-{mode}:n={n_loc}:"
                f"x_len={win.numel()}:ndiag={len(blk.offsets)}")
        expect_path(dia_spmv, name, kern, dia_spmv.vector_path(
            blk, win, base, {"spmv": (), "residual": (b1,),
                             "jacobi": (b1, s1)}[mode], sms()))
        rows["dia_spmv"].append(compare(
            name, kern, plain, DIA_BOUND, nbytes, flush,
            library=library.get(mode), flops=2 * len(blk.offsets) * n_loc))
    del solver, dh, band, library

    # 10c: sharded GPU/CPU iteration parity
    parity(f"sharded d={SHARDS} n={SHARD_PARITY_N}^3",
           amg.poisson3d_7pt(SHARD_PARITY_N), params, (SHARD_PARITY_N,) * 3,
           shards=SHARDS, transport="remote", agg_rows_per_dev=64)
    return launches, run, rows


def histories(tag, info):
    """Print a solve's PCG residual history per outer pass."""
    for k, hist in enumerate(info["residual_histories"]):
        print(f"history {tag} outer={k}: "
              + " ".join(f"{h:.6e}" for h in hist), flush=True)


def check_certified(label, info, scipy_rel):
    """Phase 11's residual contract: certified and scipy f64 ≤ 1e-8."""
    if info["rel_residual"] > 1e-8 or scipy_rel > 1e-8:
        raise AssertionError(f"{label}: certified {info['rel_residual']:.3e}"
                             f", scipy {scipy_rel:.3e}: above 1e-8")


def pmis27_kernel_checks(hier, rng, flush):
    """``dia_spmv`` on the 27-diagonal fine level (its bf16 planes) and
    ``csr_spmv`` on level 1's A, P and R (f32) of the PMIS 27-point
    hierarchy, against their twins."""
    import torch

    from omp_amg_tpu_torch.ops import csr_spmv

    lv0, lv1 = hier.levels[0], hier.levels[1]
    rows = {"dia_spmv": dia_checks("P27-L0-A", lv0.a, lv0.s, rng, flush,
                                   (lv0.a.data.dtype,)),
            "csr_spmv": []}
    dev = hier.device
    for opname, op in (("A", lv1.a), ("P", lv1.p), ("R", lv1.r)):
        m, k = op.shape
        x, b, v = _vec(rng, k, dev), _vec(rng, m, dev), _vec(rng, m, dev)
        csr = library_csr(op.indptr, op.indices, op.vals, op.shape)
        cb = (op.nnz * (4 + op.vals.element_size()) + 8 * (m + 1) + 4 * k
              + 4 * m)
        cases = {"spmv": (lambda: csr_spmv.spmv(op, x),
                          lambda: csr_spmv.csr_spmv_plain(op, x), cb,
                          library_spmv(csr, x))}
        if opname == "A":
            cases["residual"] = (
                lambda: csr_spmv.residual(op, x, b),
                lambda: csr_spmv.csr_spmv_plain(op, x, "residual", b=b),
                cb + 4 * m, library_addmm(csr, x, b, -1))
            cases["jacobi"] = (
                lambda: csr_spmv.jacobi(op, x, b, lv1.s),
                lambda: csr_spmv.csr_spmv_plain(op, x, "jacobi", b=b,
                                                s=lv1.s), cb + 8 * m, None)
        if opname == "P":
            cases["correct"] = (
                lambda: csr_spmv.correct(op, x, v),
                lambda: csr_spmv.csr_spmv_plain(op, x, "correct", v=v),
                cb + 4 * m, library_addmm(csr, x, v, 1))
        vt = "bf16" if op.vals.dtype == torch.bfloat16 else "f32"
        for mode, (kern, plain, nbytes, lib) in cases.items():
            rows["csr_spmv"].append(compare(
                f"csr_spmv:P27-L1-{opname}:{vt}:{mode}:rows={m}:"
                f"nnz={op.nnz}:V={op.vec}", kern, plain, CSR_BOUND, nbytes,
                flush, library=lib, flops=2 * op.nnz))
        del csr
    return rows


def cheby_configs(counters, rng, flush):
    """Phase 11a: bench.py's 3d27pt_128_cheby in both pipelines, its counts
    beside the TPU records. Returns ({path: launches}, kernel rows)."""
    import omp_amg_tpu_torch as amg

    a = amg.poisson3d_27pt(CHEBY_N)
    grid = (CHEBY_N,) * 3
    paths, rows = {}, {}
    for pipeline, params, g, used in (
            ("structured", amg.AMGParams(smoother="chebyshev"), grid,
             ("const_stencil", "dia_spmv")),
            ("pmis", amg.AMGParams(coarsening="pmis", smoother="chebyshev"),
             None, ("dia_spmv", "csr_spmv"))):
        label = f"cheby {pipeline} 27pt n={CHEBY_N}^3"
        solver, launches, run = drive(label, a, params, g, counters)
        expect_launches(label, launches, used)
        info = run["info"]
        check_certified(label, info, run["scipy_rel"])
        rec = TPU_RECORD_CHEBY[pipeline]
        got = (sum(info["inner_iters"]), info["outer_iters"])
        print(f"{label} inner={got[0]} ({info['inner_iters']}) "
              f"outer={got[1]} | TPU record (bench_details.json) "
              f"inner={rec[0]} outer={rec[1]}"
              f"{'' if got == rec else ' DIFFERS'}", flush=True)
        if got != rec:
            histories(label, info)
        if pipeline == "pmis":
            rows = pmis27_kernel_checks(solver.hierarchy, rng, flush)
        paths[f"cheby_{pipeline}"] = launches
        del solver
    return paths, rows


def timed_solve(solver, b, **kw):
    """One cold and one warm certified solve; (x, info, warm seconds)."""
    import torch

    solver.solve(b, tol=1e-8, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = solver.solve(b, tol=1e-8, **kw)
    torch.cuda.synchronize()
    return x, dict(solver.last_info), time.perf_counter() - t0


def option_paths(n, counters):
    """Phases 11b and 11c on the 7-point n³ PMIS and structured main paths:
    the device certified loop against the host loop, then each remaining
    option. Returns {path: launches}."""
    import dataclasses

    import torch

    import omp_amg_tpu_torch as amg

    a = amg.poisson3d_7pt(n)
    b = amg.default_rhs(a, seed=SEED)
    b_card = b.to("cuda")
    b64 = b.numpy().astype(np.float64)
    a_sp = amg.dia_to_scipy(a)
    paths = {}

    def scipy_rel(x):
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
        return float(np.linalg.norm(b64 - a_sp @ x) / np.linalg.norm(b64))

    def zero():
        for mod in counters.values():
            mod.launches = 0

    def read():
        return {name: mod.launches for name, mod in counters.items()}

    for pipeline, base, grid in (("pmis", amg.AMGParams(coarsening="pmis"),
                                  None),
                                 ("structured", amg.AMGParams(), (n,) * 3)):
        tag = f"{pipeline} n={n}^3"
        t0 = time.perf_counter()
        solver = amg.AMGSolver(a, base, grid=grid, device="cuda")
        torch.cuda.synchronize()
        print(f"variants {tag} base setup_s={time.perf_counter() - t0:.3f}",
              flush=True)

        # 11c: the device certified loop against the host loop
        x_h, host, host_s = timed_solve(solver, b, residual="host")
        x_d, dev, dev_s = timed_solve(solver, b, residual="device")
        xt, _, card_s = timed_solve(solver, b_card, residual="device",
                                    device_result=True)
        rels = {mode: scipy_rel(x) for mode, x in (("host", x_h),
                                                   ("device", x_d))}
        print(f"device loop {tag}: host inner={host['inner_iters']} "
              f"outer={host['outer_iters']} certified="
              f"{host['rel_residual']:.3e} scipy={rels['host']:.3e} "
              f"warm_solve_s={host_s:.4f} | device inner="
              f"{dev['inner_iters']} outer={dev['outer_iters']} certified="
              f"{dev['rel_residual']:.3e} scipy={rels['device']:.3e} "
              f"warm_solve_s={dev_s:.4f} | device, b on the card, "
              f"device_result warm_solve_s={card_s:.4f}", flush=True)
        if (dev["inner_iters"], dev["outer_iters"]) != (host["inner_iters"],
                                                        host["outer_iters"]):
            histories(f"{tag} host", host)
            histories(f"{tag} device", dev)
            raise AssertionError(f"{tag}: the device loop's counts differ "
                                 "from the host loop's")
        check_certified(f"{tag} device loop", dev, rels["device"])
        if not (rels["device"] <= 2 * dev["rel_residual"]
                and dev["rel_residual"] <= 2 * rels["device"]):
            raise AssertionError(f"{tag}: the device loop's residual is not "
                                 "within 2x of scipy's")
        if not (xt.is_cuda and xt.dtype == torch.float64
                and np.array_equal(xt.cpu().numpy(), x_d)):
            raise AssertionError(f"{tag}: device_result differs from the "
                                 "host x of the device loop")
        print(f"device loop {tag}: device_result is a CUDA float64 tensor, "
              "bitwise the host x", flush=True)
        if pipeline == "pmis":
            profile_solve(f"{tag} host loop", solver, b, residual="host")
            profile_solve(f"{tag} device loop", solver, b, residual="device")
        profile_solve(f"{tag} device loop, b on the card, device_result",
                      solver, b_card, residual="device", device_result=True)

        # 11b: the options; W, F and the pipelined PCG reuse the setup
        hier0 = solver.hierarchy
        per_cycle = {}
        for cycle in ("v", "w", "f"):
            solver.hierarchy = dataclasses.replace(
                hier0, params=dataclasses.replace(base, cycle=cycle))
            zero()
            amg.vcycle(solver.hierarchy, b_card)
            torch.cuda.synchronize()
            per_cycle[cycle] = {k: v for k, v in read().items() if v}
        print(f"variants {tag} launches per preconditioner application: "
              + " ".join(f"{c.upper()}={v}" for c, v in per_cycle.items()),
              flush=True)
        options = [("w", None, {"cycle": "w"}, {}),
                   ("f", None, {"cycle": "f"}, {}),
                   ("pipelined", None, {}, {"variant": "pipelined"}),
                   ("l1jacobi", {"smoother": "l1jacobi"}, {}, {}),
                   ("inv", {"coarse_solver": "inv", "coarse_size": 400}, {},
                    {})]
        for name, setup_kw, cycle_kw, solve_kw in options:
            label = f"variants {tag} {name}"
            setup_s = 0.0
            if setup_kw is None:
                opt = solver
                opt.hierarchy = dataclasses.replace(
                    hier0, params=dataclasses.replace(base, **cycle_kw))
            else:
                t0 = time.perf_counter()
                opt = amg.AMGSolver(a, dataclasses.replace(base, **setup_kw),
                                    grid=grid, device="cuda")
                torch.cuda.synchronize()
                setup_s = time.perf_counter() - t0
            zero()
            opt.solve(b, tol=1e-8, **solve_kw)
            torch.cuda.synchronize()
            launches = read()
            info = dict(opt.last_info)
            t0 = time.perf_counter()
            x = opt.solve(b, tol=1e-8, **solve_kw)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            rel = scipy_rel(x)
            print(f"{label} setup_s={setup_s:.3f} inner={info['inner_iters']}"
                  f" outer={info['outer_iters']} certified="
                  f"{info['rel_residual']:.3e} scipy={rel:.3e} "
                  f"residual={info['residual']} warm_solve_s={warm_s:.4f} "
                  f"launches={ {k: v for k, v in launches.items() if v} }",
                  flush=True)
            check_certified(label, info, rel)
            if name == "pipelined":
                extra = sum(info["inner_iters"]) - sum(dev["inner_iters"])
                if not 0 <= extra <= 1:
                    histories(f"{tag} standard", dev)
                    histories(f"{tag} pipelined", info)
                    raise AssertionError(f"{label}: {extra} iterations more "
                                         "than standard PCG (0 or 1 "
                                         "expected)")
                profile_solve(f"{tag} standard", solver, b)
                profile_solve(f"{tag} pipelined", solver, b,
                              variant="pipelined")
            paths[f"{pipeline}_{name}"] = launches
            if opt is not solver:
                del opt
        del solver, hier0
    return paths


def sharded_variants(n, counters):
    """Phase 11d: Chebyshev and the pipelined PCG on the z-slab path, 4
    shards against 1 (partition invariance). Returns {path: launches}."""
    import omp_amg_tpu_torch as amg
    from omp_amg_tpu_torch.parallel.dist import dist_vcycle

    a = amg.poisson3d_7pt(n)
    grid = (n,) * 3

    def vcycle(solver, r):
        return dist_vcycle(solver.hierarchy, solver.mesh.shard(r))

    paths = {}
    for name, params, solve_kw in (
            ("chebyshev", amg.AMGParams(smoother="chebyshev"), {}),
            ("pipelined", amg.AMGParams(), {"variant": "pipelined"})):
        infos = {}
        for d in (SHARDS, 1):
            label = f"sharded d={d} remote {name} n={n}^3"
            solver, launches, run = drive(
                label, a, params, grid, counters, vcycle=vcycle,
                solve_kw=solve_kw, mesh=amg.ShardMesh(d, "cuda"),
                transport="remote")
            check_certified(label, run["info"], run["scipy_rel"])
            infos[d] = run["info"]
            if d == SHARDS:
                expect_launches(label, launches, ("dia_spmv", "remote_halo"))
                paths[f"sharded_{name}"] = launches
            del solver
        four, one = infos[SHARDS], infos[1]
        diffs = [abs(u - v) for u, v in zip(four["inner_iters"],
                                             one["inner_iters"])]
        print(f"sharded {name} partition invariance: d={SHARDS} inner "
              f"{four['inner_iters']} outer {four['outer_iters']} | d=1 "
              f"inner {one['inner_iters']} outer {one['outer_iters']}",
              flush=True)
        if any(diffs) or four["outer_iters"] != one["outer_iters"]:
            histories(f"sharded {name} d={SHARDS}", four)
            histories(f"sharded {name} d=1", one)
            if max(diffs, default=0) > 1 or \
                    four["outer_iters"] != one["outer_iters"]:
                raise AssertionError(f"sharded {name}: 1-shard counts "
                                     "differ by more than one iteration")
    return paths


def variant_parity():
    """Phase 11e: the GPU/CPU iteration parity of 11a-11d at
    VARIANT_PARITY_N³."""
    import omp_amg_tpu_torch as amg

    n = VARIANT_PARITY_N
    grid = (n,) * 3
    a27 = amg.poisson3d_27pt(n)
    parity(f"cheby structured 27pt n={n}^3", a27,
           amg.AMGParams(smoother="chebyshev"), grid)
    parity(f"cheby pmis 27pt n={n}^3", a27,
           amg.AMGParams(coarsening="pmis", smoother="chebyshev"), None)
    a = amg.poisson3d_7pt(n)
    for pipeline, base, g in (("pmis", {"coarsening": "pmis"}, None),
                              ("structured", {}, grid)):
        for name, kw, solve_kw in (
                ("l1jacobi", {"smoother": "l1jacobi"}, {}),
                ("w", {"cycle": "w"}, {}), ("f", {"cycle": "f"}, {}),
                ("inv", {"coarse_solver": "inv", "coarse_size": 400}, {}),
                ("pipelined", {}, {"variant": "pipelined"}),
                ("device loop", {}, {"residual": "device"})):
            parity(f"{pipeline} {name} n={n}^3", a,
                   amg.AMGParams(**base, **kw), g, solve_kw=solve_kw)
    for name, kw, solve_kw in (("chebyshev", {"smoother": "chebyshev"}, {}),
                               ("pipelined", {}, {"variant": "pipelined"})):
        parity(f"sharded d={SHARDS} {name} n={n}^3", a, amg.AMGParams(**kw),
               grid, shards=SHARDS, solve_kw=solve_kw, transport="remote",
               agg_rows_per_dev=64)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=128,
                    help="grid edge of the 3D 7-point Poisson main paths")
    args = ap.parse_args()

    import torch

    # phase 1: the card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 1
    card = card_info()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    global PEAK
    PEAK = card_peak(torch.cuda.get_device_name(0))
    print(f"bounds: published {PEAK[2]} peaks, {PEAK[0] / 1e12:g} TB/s and "
          f"{PEAK[1] / 1e12:g} f32 TFLOP/s (at the full power limit; this "
          f"card: {card})", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import omp_amg_tpu_torch as amg
    from omp_amg_tpu_torch import _build, native
    from omp_amg_tpu_torch.ops import (
        const_stencil, csr_spmv, dia_spmv, extract_lanes, panel_spmm,
        remote_halo,
    )
    from omp_amg_tpu_torch.sparse.formats import bf16_lossless

    counters = {"const_stencil": const_stencil, "dia_spmv": dia_spmv,
                "csr_spmv": csr_spmv, "panel_spmm": panel_spmm,
                "extract_lanes": extract_lanes, "remote_halo": remote_halo}

    # phase 2: builds
    t0 = time.perf_counter()
    _build.native_library()
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    _build.cuda_kernels()
    t_cuda = time.perf_counter() - t0
    print(f"build native_s={t_native:.2f} cuda_s={t_cuda:.2f} "
          f"native.available()={native.available()}", flush=True)
    if not native.available():
        raise RuntimeError(f"native setup library unavailable: "
                           f"{native.build_error()}")

    pmis = amg.AMGParams(coarsening="pmis")
    probe = amg.AMGParams(coarsening="pmis", rap="probe")
    rng = np.random.default_rng(SEED)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    # phase 3: PMIS kernel checks on the real level operators
    a = amg.poisson3d_7pt(args.n)
    hier = amg.amg_setup(a, pmis, device="cuda")
    rows = pmis_kernel_checks(hier, rng, flush)
    del hier

    # phase 4: the PMIS main path, the launches of one V-cycle, and a
    # profile of one warm solve
    solver, pmis_launches, host_run = drive(f"pmis n={args.n}^3", a, pmis,
                                            None, counters)
    expect_launches("pmis", pmis_launches, ("dia_spmv", "csr_spmv"))
    if pmis_launches["dia_spmv"] == host_run["scalar"]["dia_spmv"]:
        raise AssertionError("pmis: dia_spmv never took its vector path")
    for mod in counters.values():
        mod.launches = 0
    amg.vcycle(solver.hierarchy, amg.default_rhs(a, seed=SEED).to("cuda"))
    torch.cuda.synchronize()
    print(f"pmis n={args.n}^3 one V-cycle: levels="
          f"{len(solver.hierarchy.levels)} launches="
          f"{ {k: m.launches for k, m in counters.items() if m.launches} }",
          flush=True)
    profile_solve(f"pmis n={args.n}^3", solver,
                  amg.default_rhs(a, seed=SEED))
    del solver

    # phase 5: PMIS GPU/CPU iteration parity
    parity(f"pmis n={PARITY_N}^3", amg.poisson3d_7pt(PARITY_N), pmis, None,
           (TPU_RECORD_64["inner"], TPU_RECORD_64["outer"]))

    # phase 5a: probe-kernel checks on the rap="probe" hierarchy's operands
    host, probe_rows = probe_setup_checks(a, probe, flush)
    rows.update(probe_rows)

    # phase 5b: the probe main path; its hierarchy is the one checked in 5a
    solver, probe_launches, probe_run = drive(f"pmis probe n={args.n}^3", a,
                                              probe, None, counters)
    expect_launches("pmis probe", probe_launches,
                    ("dia_spmv", "csr_spmv", "panel_spmm", "extract_lanes"))
    for l, lv in enumerate(solver.hierarchy.levels[1:], 1):
        want = torch.from_numpy(host.ops[l].data.astype(np.float32))
        if not torch.equal(lv.a.vals.cpu(), want.to(lv.a.vals.dtype)):
            raise AssertionError(f"pmis probe: level {l}'s A differs from "
                                 "the checked setup's")
    hi, pi = host_run["info"], probe_run["info"]
    print(f"pmis probe vs host n={args.n}^3: setup_s "
          f"{probe_run['setup_s']:.3f} vs {host_run['setup_s']:.3f}; inner "
          f"{pi['inner_iters']} vs {hi['inner_iters']}; outer "
          f"{pi['outer_iters']} vs {hi['outer_iters']}", flush=True)
    if (pi["inner_iters"], pi["outer_iters"]) != (hi["inner_iters"],
                                                  hi["outer_iters"]):
        for tag, info in (("probe", pi), ("host", hi)):
            for k, hist in enumerate(info["residual_histories"]):
                print(f"history pmis {tag} outer={k}: "
                      + " ".join(f"{h:.6e}" for h in hist), flush=True)
    del solver, host

    # phase 5c: bench.py's numeric-phase measurement, on the card
    rap_bench(RAP_BENCH_N)

    # phase 5d: probe GPU/CPU iteration parity
    parity(f"pmis probe n={PARITY_N}^3", amg.poisson3d_7pt(PARITY_N), probe,
           None)

    # phase 6: const_stencil kernel checks
    rows["const_stencil"] = []
    for tag, op in ((f"7pt{CONST_N}", amg.poisson3d_7pt(CONST_N)),
                    (f"7pt{args.n}", a),
                    (f"27pt{args.n}", amg.poisson3d_27pt(args.n))):
        rows["const_stencil"] += const_checks(tag, op, rng, flush)
        del op

    def banded_checks(tag, lv):
        dts = [torch.float32]
        if bf16_lossless(lv.a.data.float().cpu().numpy()):
            dts.append(torch.bfloat16)
        rows["dia_spmv"] += dia_checks(tag, lv.a, lv.s, rng, flush, dts)

    # phase 7: the 3D structured main path, then dia_spmv on its levels
    solver, s3_launches, s3_run = drive(f"structured n={args.n}^3", a,
                                   amg.AMGParams(), (args.n,) * 3, counters)
    expect_launches("structured 3D", s3_launches,
                    ("const_stencil", "dia_spmv"))
    for l, lv in enumerate(solver.hierarchy.levels[1:], 1):
        banded_checks(f"S3-L{l}-A", lv)
    del solver

    # phase 8: the 2D structured path, then dia_spmv on its 1024² and 512²
    # operators
    a2 = amg.poisson2d_5pt(N2D)
    solver, s2_launches, s2_run = drive(f"structured 2D n={N2D}^2", a2,
                                   amg.AMGParams(), (N2D, N2D), counters)
    expect_launches("structured 2D", s2_launches, ("dia_spmv",))
    if s2_run["scalar"]["dia_spmv"] in (0, s2_launches["dia_spmv"]):
        raise AssertionError("structured 2D: dia_spmv did not launch both "
                             f"paths ({s2_run['scalar']['dia_spmv']} scalar "
                             f"of {s2_launches['dia_spmv']})")
    for l, lv in enumerate(solver.hierarchy.levels[:2]):
        banded_checks(f"S2-L{l}-A", lv)
    del solver, a2

    # phase 9: structured GPU/CPU iteration parity on bench.py's configs
    # (f32 operator values, as bench.py's generators give them)
    for label, (gen, gargs, grid, record) in STRUCTURED_PARITY.items():
        op = getattr(amg, gen)(*gargs)
        op = amg.Dia(data=op.data.astype(np.float32).astype(np.float64),
                     offsets=op.offsets, dims=op.dims)
        parity(label, op, amg.AMGParams(), grid, record)

    # phase 10: the z-slab distributed structured path on one card
    sh_launches, sh_run, sh_rows = sharded_path(args.n, counters, flush, rng)
    rows["remote_halo"] = sh_rows["remote_halo"]
    rows["dia_spmv"] += sh_rows["dia_spmv"]

    # phase 11: the smoother, cycle, coarse-solve and Krylov options and
    # the device certified loop
    cheby_paths, cheby_rows = cheby_configs(counters, rng, flush)
    for name, more in cheby_rows.items():
        rows[name] += more
    option_launches = option_paths(args.n, counters)
    sharded_launches = sharded_variants(args.n, counters)
    variant_parity()

    if any(m.startswith(("jax", "omp_amg_tpu.")) or m == "omp_amg_tpu"
           for m in sys.modules):
        raise AssertionError("the JAX package was imported")

    paths = {"pmis": pmis_launches, "pmis_probe": probe_launches,
             "structured_3d": s3_launches, "structured_2d": s2_launches,
             "sharded_3d": sh_launches, **cheby_paths, **option_launches,
             **sharded_launches}
    launches = {name: sum(p[name] for p in paths.values())
                for name in counters}
    print("main-path launches: " + " ".join(f"{k}={v}"
                                            for k, v in paths.items()),
          flush=True)
    runs = {"pmis": host_run, "pmis_probe": probe_run,
            "structured_3d": s3_run, "structured_2d": s2_run,
            "sharded_3d": sh_run}
    print("main-path dia_spmv launches, vector / scalar path: " + " ".join(
        f"{k}={paths[k]['dia_spmv'] - r['scalar']['dia_spmv']}/"
        f"{r['scalar']['dia_spmv']}" for k, r in runs.items()), flush=True)

    def summary(name, source, replaces, main):
        main_row = next(r for r in rows[name] if r["name"].startswith(main))
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
                "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"],
                "bound_by": main_row["bound_by"],
                "bound_us": main_row["bound_us"],
                "library_ms": main_row["library_ms"]}

    print(f"kernels line: launches sum the {len(paths)} main paths; ms, "
          f"plain_ms, "
          f"library_ms and bound time const_stencil:7pt{CONST_N}:spmv, "
          f"dia_spmv:L0-A:bf16:spmv, csr_spmv:L1-A:f32:spmv, "
          f"panel_spmm:L0-A·PV, extract_lanes:L0 and "
          f"remote_halo:L0:d={SHARDS} (the windows) with a cold L2; "
          f"max_abs_err is the largest over all checks; bounds against "
          f"{PEAK[2]} peaks, this card {card}", flush=True)
    print(json.dumps({"kernels": [
        summary("const_stencil", "omp_amg_tpu_torch/csrc/const_stencil.cu",
                "omp_amg_tpu/ops/pallas_const.py:39",
                f"const_stencil:7pt{CONST_N}:spmv"),
        summary("dia_spmv", "omp_amg_tpu_torch/csrc/dia_spmv.cu",
                "omp_amg_tpu/ops/pallas_spmv.py:144, "
                "omp_amg_tpu/ops/pallas_spmv.py:51",
                "dia_spmv:L0-A:bf16:spmv"),
        summary("csr_spmv", "omp_amg_tpu_torch/csrc/csr_spmv.cu",
                "omp_amg_tpu/ops/pallas_routed.py:101",
                "csr_spmv:L1-A:f32:spmv"),
        summary("panel_spmm", "omp_amg_tpu_torch/csrc/panel_spmm.cu",
                "omp_amg_tpu/ops/pallas_spmm.py:102, "
                "omp_amg_tpu/ops/pallas_spmm.py:262, "
                "omp_amg_tpu/ops/pallas_spmm.py:508",
                "panel_spmm:L0-A·PV"),
        summary("extract_lanes", "omp_amg_tpu_torch/csrc/extract_lanes.cu",
                "omp_amg_tpu/ops/pallas_spmm.py:624",
                "extract_lanes:L0"),
        summary("remote_halo", "omp_amg_tpu_torch/csrc/remote_halo.cu",
                "omp_amg_tpu/parallel/slab.py:138, "
                "omp_amg_tpu/parallel/slab.py:172",
                f"remote_halo:L0:d={SHARDS}:"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
