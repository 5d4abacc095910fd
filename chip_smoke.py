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
3c. ``tile_csr`` checks: on every A and R with rows of 8 lanes or more of
   the ``pmis7_256`` and ``pmis27_128_cheby`` cells' hierarchies
   (``poisson3d_7pt(TILE_N)`` PMIS, ``poisson3d_27pt(CHEBY_N)`` PMIS
   Chebyshev with the probed Galerkin values), the tiled kernel bitwise the
   CSR kernel on the same operator, against its twin, and timed beside the
   CSR kernel (``tile`` and ``tilecmp`` lines: the rule's verdict beside
   both kernels' µs);
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
6a. ``grid_transfer`` kernel checks: restrict, prolong and prolong-add at
   256³ → 128³ in f32 and f64 against the slice-form twin on the same CUDA
   tensors, bit for bit, each timed beside its bound and the twin;
6b. ``pcg_update`` kernel checks: ``xr`` and ``p`` on 256³ vectors in f32
   and f64 against the where-form twin, bit for bit, a false flag writing
   nothing, each timed beside its bound and the twin;
6c. one captured standard PCG solve on the PMIS and the structured 256³
   paths and on the 256³ z-slab path over ``SHARDS`` shards of the card
   against the where-form step the kernel replaced, captured the same way:
   count, history and x bit for bit, 2 ``pcg_update`` launches per shard
   and executed iteration, both solves timed (where-form, kernel, kernel,
   where-form) and profiled;
6d. ``ir_f64`` kernel checks (the certified loop's f64 work): the residual
   on 7-point 256³ and 27-point 128³ f64 planes, the defect and the
   in-place update, against the twins on the same CUDA tensors, bit for
   bit, each timed beside its bound, the twin and one torch call;
6e. one certified 256³ 7-point structured solve through the ``ir_f64``
   kernels against the same solve with the twins in their place: x, counts,
   histories and residual bit for bit, 3 launches per outer pass plus 1,
   both timed and profiled;
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
   PMIS levels 0 and 1; then PMIS with ``rap="probe"`` (the benchmark's
   ``pmis27_128_cheby``): phase 5a's checks on its levels, those above 256
   colours (three colour groups) included, its counts beside the
   host-valued setup's, and its solve and V-cycle timed both as ``drive``
   and as the benchmark's cell times them; (11c) on the 7-point n³ PMIS
   and structured paths
   the device certified loop (``residual="device"``, the default on the
   card) against the host loop: equal counts, ``device_result=True``
   bitwise the host x, warm times and profiles; (11b) there too the W and F
   cycles and the pipelined PCG on that setup (launches of one cycle
   application of each cycle type; the pipelined count standard's or one
   more; profiles of both PCGs, with their device-to-host copies), and
   l1-Jacobi and the ``inv`` coarse solve on their own setups; (11d)
   Chebyshev and the pipelined PCG on the 4-shard path against 1 shard;
   (11e) the GPU/CPU iteration parity of all of them at 32³;
12. the value-only refresh and the CLI: (12a) ``bench.py``'s
   ``refresh128``: ``poisson3d_27pt(128)`` PMIS Chebyshev with a
   ``SetupCache``, refreshed ×2.0 (cold) and ×0.5 (warm): fresh, cold and
   warm seconds, the cache's MB, host → device bytes of the warm refresh
   against the fresh setup's, the largest relative value error against a
   fresh setup of the ×0.5 operator (≤ 2e-6), the index tensors shared with
   the cached hierarchy, PCG counts to 1e-6 refreshed and fresh (equal)
   beside the TPU record; then ``AMGSolver(poisson3d_7pt(128),
   AMGParams(coarsening="pmis"), refreshable=True).refresh(×1.7)`` and a
   certified solve (≤ 1e-8, a fresh solver's counts, no fallback); (12b)
   ``cli.main`` on the card: ``--problem 3d7pt --n 128`` (structured),
   the same with ``--coarsening pmis --save-hierarchy``, then
   ``--load-hierarchy`` (equal iters, the loaded tensors bitwise the
   saved), ``--matrix`` on a MatrixMarket ``poisson3d_7pt(64)``, each with
   its kernels' launches; and one ``python -m omp_amg_tpu_torch.cli``
   subprocess;
13. the row-sharded PMIS path on one card: (13a) ``AMGSolver(
   poisson3d_7pt(n), AMGParams(coarsening="pmis"), mesh=ShardMesh(4),
   transport="remote", refreshable=True)`` with ``csr_spmv`` and
   ``remote_halo`` checks on its shard windows; (13b) ``ppermute`` bitwise
   ``remote``, the per-shard setup bitwise on 1, 2 and 4 shards, their
   counts and the central route's; (13c) the distributed refresh ×2.0
   against a fresh solver and ×1.7 with its tie repair; (13d) both mesh
   paths certify the user's f64 operator at 24³ × 1.7;
14. the captured PCG blocks (``solvers/graph.py``, the default on the
   card) against the per-iteration loop (``solve(..., graph=False)``) on
   the PMIS n³ path (standard and pipelined PCG), the structured n³ path
   (V and W cycles), the z-slab path on 4 shards and the PMIS mesh path
   on 4 shards (13c's fresh solver; standard and pipelined): equal inner
   and outer counts, certified ≤ 1e-8, scipy ≤ 2e-8, max |Δx| (0 unless
   the capture changed a kernel's path), the warm wall (median of 5), busy
   time and share under ``torch.profiler``, host enqueue µs per block,
   capture seconds, the graph pool's MB, blocks and frozen iterations per
   solve, and the device ms of one start and one block replay (CUDA
   events); ``ksweep`` lines time block sizes 1, 2, 4 and 8 on the serial
   paths; a ×2.0 refresh of the PMIS solver drops its graphs and solves,
   captured, in a fresh solver's counts; then ``spmv_dia`` and
   ``spmv_csr`` of the public sparse API on the PMIS levels and on
   operators built by ``dia_from_scipy``/``dia_to_csr`` (on the card by
   default) against the kernels' twins;
15. the device-flavor setups (``flavor="device"``), each against the host
   flavor through ``AMGSolver`` (both main paths, their setups traced with
   ``OMP_AMG_SETUP_TIMERS=1``: seconds and phases, and the launches of the
   setup alone): (15a) PMIS n³ with direct interpolation (levels, C/F
   states bitwise, every A_l within 1e-5 of its scale, dinv within 1e-5,
   λmax within 1e-3, counts equal or a difference of one traced, certified
   ≤ 1e-8; ``dia_spmv`` and ``csr_spmv`` launched by the device λmax);
   (15b) structured n³ (coarse shapes and axes, planes within 1e-5 of the
   host's f64 planes, λmax within 1e-2, ``ConstDia`` at L0, the RAP engine
   per level; at L0 the factored engine against the comb engine within
   1e-5, and again with ``allow_tf32 = True``, within 1e-6 of the first);
   (15c) ``aniso9pt_256_eps1e-3`` on the device flavor: (True, False) at
   L0, its count beside the TPU record; (15d) ``cli.main`` with
   ``--problem 3d7pt --n 256 --setup-flavor device``: no host planes built
   beyond the tiny f32 check, build, setup and solve seconds, certified ≤
   1e-8, the count beside the TPU record; (15e) GPU/CPU iteration parity
   of both device flavors at 32³;
16. the mesh that spans processes: the script starts itself twice more as
   two ranks on the one card (``--phase16-rank``, gloo, the
   ``OMP_AMG_COORDINATOR`` gate at a free port; each rank's counters set
   to 0 just before its main path and read just after, summed over the
   ranks); (16a) PMIS n³ on ``global_mesh(2)`` (2 × 2 shards) through
   ``AMGSolver(..., transport="remote")``, certified ``tol=1e-8``: counts
   and x those of phase 13's one-process ``ShardMesh(4)`` (max|Δx| 0),
   setup seconds, the warm solve (median of 5), ``mesh.stats`` (calls,
   bytes and transfer seconds per solve and per iteration), ``graph_stats``
   reporting the eager block loop; (16b) z-slab n³ on the same mesh with
   ``transport="remote"`` (the cross-process ``remote_halo``, CUDA IPC
   mailboxes) and ``"ppermute"``: bitwise equal, counts those of phase
   10, and x bitwise phase 10's; on each rank the cross-process window at
   L0 exact against the twin on the gathered shards, the kernel timed
   against its twin (cold L2), and the whole exchange (strip copies,
   stream sync, barrier, launch) and the ``ppermute`` strips on the host
   clock; (16c) the scaling model's machine constants on this card (a
   1 GiB copy, the per-call floor of ``csr_spmv``) and its reports for
   PMIS and structured n³ calibrated to each one's measured V-cycle.
   A rank that fails makes the script fail.

Since slice 11 every solve on the card runs the captured blocks, so the
main paths' launch counts include the frozen iterations of the last block
of each PCG solve.

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
import os
import subprocess
import sys
import time

import numpy as np

DIA_BOUND = 1e-6    # ≤ 27 f32 terms summed: only the order may differ
CSR_BOUND = 1e-5    # rows of up to ~100 terms, summed in another order
CONST_BOUND = 0.0   # same products and order as the twin: bitwise
TRANSFER_BOUND = 0.0  # grid_transfer: the twin's nesting and rounding
TRANSFER_N = 256    # grid_transfer checks: the structured cell's level 0
PCG_BOUND = 0.0     # pcg_update: the where-form's rounding, bit for bit
PCG_N = 256         # pcg_update checks and the where-form check: the
                    # benchmark cells' 256³
PCG_TOL = 1e-6      # the where-form check's solve (f32 PCG)
IR_BOUND = 0.0      # ir_f64: the certified loop's torch forms, bit for bit
TILE_N = 256        # tile_csr rows: the pmis7_256 cell's hierarchy
IR_N = 256          # ir_f64 rows (7-point) and the certified-solve check
IR27_N = 128        # ir_f64 rows on the 27-point cell's 128³
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
# bench.py's refresh128 (27-point 128³ PMIS Chebyshev, refreshed ×2.0 then
# ×0.5) and its TPU record (bench_details.json refresh_warm_iters: PCG
# iterations to 1e-6 on the ×0.5 operator)
REFRESH_N = 128
TPU_RECORD_REFRESH = 7
REFRESH_BOUND = 2e-6    # refreshed against fresh values (f32 roundoff)
REFRESH_SOLVER_N = 128  # the facade's ×1.7 refresh on the 7-point path
CLI_N = 128             # the CLI's generated problems
CLI_MATRIX_N = 64       # the CLI's MatrixMarket file: poisson3d_7pt(64)
GRAPH_RUNS = 5          # phase 14: warm solves per loop (median reported)
GRAPH_KSWEEP = (1, 2, 4, 8)  # phase 14: block sizes swept on the serial paths
DEVICE_CLI_N = 256      # phase 15d: the CLI's device-only build
TPU_RECORD_CLI_256 = (14, 2)  # BASELINE.md:123 (inner summed, outer)
DEVICE_PARITY_N = 32    # phase 15e: GPU/CPU parity of the device flavors
STEP0_N = 24            # the f64-certificate check: 24³ × 1.7
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
            d, n, nl, nr, out.shape[1], vec, table, None, None,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
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
            0, 0, vec, a.n_rows, 0, a.indptr.data_ptr(), a.indices.data_ptr(),
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
    from omp_amg_tpu_torch.sparse.formats import (
        Csr, Dia, TileCsr, tile_to_csr,
    )

    dev = hier.device
    lv0 = hier.levels[0]
    if not isinstance(lv0.a, Dia):
        raise AssertionError("fine level is not banded")
    rows = {"dia_spmv": dia_checks("L0-A", lv0.a, lv0.s, rng, flush,
                                   (torch.float32, torch.bfloat16)),
            "csr_spmv": []}
    for l, lv in enumerate(hier.levels):
        ops = [("P", lv.p), ("R", tile_to_csr(lv.r))]
        if isinstance(lv.a, (Csr, TileCsr)):
            ops.insert(0, ("A", tile_to_csr(lv.a)))
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


def tile_bytes(t, m, k, vecs) -> int:
    """Bytes the tiled kernel needs, each read once: indptr, the 16-bit
    indices, the values, the tiles' column lists and tables, x, the row
    vectors the mode reads and y."""
    return (8 * (m + 1) + t.nnz * (2 + t.vals.element_size())
            + 4 * t.tile_cols.numel() + 16 * (t.n_tiles + 1) + 4 * k
            + 4 * m * (1 + vecs))


def tile_csr_checks(tag, a, params, flush):
    """The tiled CSR kernel on every A and R of ``a``'s hierarchy under
    ``params`` with rows of at least 8 lanes (the rule's first test), in
    its level's value type: bitwise the CSR kernel on the same operator in
    each mode (A: spmv, residual, jacobi; R: spmv), against its twin, and
    timed with a cold L2 beside the CSR kernel (``tile`` lines: the rule's
    verdict, unique share, tiles, window; ``tilecmp`` lines: µs of both
    kernels). An operator the rule keeps on ``Csr`` is timed in the form
    it would take. Rows of the kernels line."""
    import torch

    import omp_amg_tpu_torch as amg
    from omp_amg_tpu_torch.ops import csr_spmv, tile_csr as tile_ops
    from omp_amg_tpu_torch.sparse.formats import (
        Csr, TileCsr, tile_csr, tile_to_csr,
    )

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    hier = amg.amg_setup(a, params, device="cuda")
    print(f"tile setup {tag} s={time.perf_counter() - t0:.1f} "
          f"tiled={hier.tiled} nnz_share={hier.tiled_nnz_share:.4f}",
          flush=True)
    rows = []
    for l, lv in enumerate(hier.levels):
        for opname, op in (("A", lv.a), ("R", lv.r)):
            if not isinstance(op, (Csr, TileCsr)):
                continue
            c = tile_to_csr(op)
            if c.vec < 8:
                continue
            taken = isinstance(op, TileCsr)
            t = op if taken else tile_csr(c)
            if t is None:
                print(f"tile {tag} L{l}-{opname}: no tiled form", flush=True)
                continue
            m, k = c.shape
            vt = "bf16" if c.vals.dtype == torch.bfloat16 else "f32"
            print(f"tile {tag} L{l}-{opname}:{vt} rows={m} nnz={c.nnz} "
                  f"V={c.vec} rule={'tiled' if taken else 'csr'} "
                  f"unique_share={t.unique_share:.4f} tiles={t.n_tiles} "
                  f"window={t.window}", flush=True)
            x, b, s = (_vec(rng, k, "cuda"), _vec(rng, m, "cuda"),
                       lv.s if opname == "A" else None)
            modes = {"spmv": ((x,), 0)}
            if opname == "A":
                modes.update(residual=((x, b), 1), jacobi=((x, b, s), 2))
            for mode, (args, vecs) in modes.items():
                def kern(mode=mode, args=args):
                    return getattr(tile_ops, mode)(t, *args)

                def csr(mode=mode, args=args):
                    return getattr(csr_spmv, mode)(c, *args)
                got, want = kern(), csr()
                torch.cuda.synchronize()
                name = (f"tile_csr:{tag}:L{l}-{opname}:{vt}:{mode}:rows={m}:"
                        f"nnz={c.nnz}:V={c.vec}")
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{name}: not the CSR kernel's bits (max|Δ| "
                        f"{float((got - want).abs().max()):.3e})")
                nbytes = tile_bytes(t, m, k, vecs)
                row = compare(
                    name, kern, lambda mode=mode, args=args:
                    tile_ops.tile_csr_plain(
                        t, args[0], mode,
                        b=args[1] if len(args) > 1 else None,
                        s=args[2] if len(args) > 2 else None),
                    CSR_BOUND, nbytes, flush, flops=2 * c.nnz)
                rows.append(row)
                csr_ms = cuda_ms(csr, flush=flush)
                print(f"tilecmp {name} rule={'tiled' if taken else 'csr'} "
                      f"tiles={t.n_tiles} unique_share={t.unique_share:.4f} "
                      f"tile_us={row['ms'] * 1e3:.2f} "
                      f"csr_us={csr_ms * 1e3:.2f} "
                      f"ratio={row['ms'] / csr_ms:.4f} bound_us="
                      f"{nbytes / PEAK[0] * 1e6:.2f}", flush=True)
            del t, c, x, b
    del hier
    torch.cuda.empty_cache()
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


def grid_transfer_checks(rng, flush):
    """The grid-transfer kernel's three modes at ``TRANSFER_N``³ →
    (``TRANSFER_N``/2)³, all axes coarsened, in f32 and f64, against the
    slice-form twin on the same CUDA tensors (bitwise); bytes count the
    input vectors read once and the output written once."""
    import torch

    from omp_amg_tpu_torch.amg.structured import (
        GridProlong, GridRestrict, apply_prolong, apply_restrict,
    )
    from omp_amg_tpu_torch.ops import grid_transfer as gt

    kw = dict(fine_shape=(TRANSFER_N,) * 3,
              coarse_shape=(TRANSFER_N // 2,) * 3, coarsened=(True,) * 3)
    p, r = GridProlong(**kw), GridRestrict(**kw)
    nf, nc = p.n_rows, p.n_cols
    rows = []
    for tag, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        size = torch.finfo(dtype).bits // 8
        xf, x = (_vec(rng, nf, "cuda").to(dtype) for _ in range(2))
        xc = _vec(rng, nc, "cuda").to(dtype)
        cases = {
            "restrict": (lambda: gt.restrict(r, xf),
                         lambda: apply_restrict(r, xf), size * (nf + nc)),
            "prolong": (lambda: gt.prolong(p, xc),
                        lambda: apply_prolong(p, xc), size * (nc + nf)),
            "prolong-add": (lambda: gt.correct(p, xc, x),
                            lambda: x + apply_prolong(p, xc),
                            size * (nc + 2 * nf)),
        }
        rows += [compare(f"grid_transfer:{TRANSFER_N}^3:{mode}:{tag}", kern,
                         pl, TRANSFER_BOUND, nbytes, flush)
                 for mode, (kern, pl, nbytes) in cases.items()]
    return rows


def pcg_update_checks(rng, flush):
    """The PCG update kernel's two entry points on ``PCG_N``³ vectors, f32
    and f64, masked by a true flag as the captured step runs them, against
    the plain twin (the where-form written back) on the same CUDA tensors,
    bitwise; a false flag writes nothing. Bytes: xr reads x, p, r, q and
    writes x, r; p reads z, p and writes p. Each timed call updates its own
    buffers in place again."""
    import torch

    from omp_amg_tpu_torch.ops import pcg_update as pu

    n = PCG_N ** 3
    rows = []
    for tag, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        size = torch.finfo(dtype).bits // 8
        vecs = [_vec(rng, n, "cuda").to(dtype) for _ in range(5)]
        alpha = torch.tensor(0.37, dtype=dtype, device="cuda")
        beta = torch.tensor(0.61, dtype=dtype, device="cuda")
        on = torch.tensor(True, device="cuda")
        off = torch.tensor(False, device="cuda")
        kx, kr, kp, kq, kz = (v.clone() for v in vecs)
        tx, tr, tp, tq, tz = (v.clone() for v in vecs)
        pu.xr(kx, kr, kp, kq, alpha, off)
        pu.p_update(kp, kz, beta, off)
        torch.cuda.synchronize()
        if not all(torch.equal(u, v) for u, v in zip((kx, kr, kp), vecs)):
            raise AssertionError(f"pcg_update {tag}: a false flag wrote")
        cases = {
            "xr": (lambda: pu.xr(kx, kr, kp, kq, alpha, on) or (kx, kr),
                   lambda: pu.xr_twin(tx, tr, tp, tq, alpha, on) or (tx, tr),
                   6 * size * n),
            "p": (lambda: pu.p_update(kp, kz, beta, on) or (kp,),
                  lambda: pu.p_twin(tp, tz, beta, on) or (tp,),
                  3 * size * n),
        }
        rows += [compare(f"pcg_update:{PCG_N}^3:{mode}:{tag}", kern, pl,
                         PCG_BOUND, nbytes, flush, flat=torch.cat)
                 for mode, (kern, pl, nbytes) in cases.items()]
        del vecs, kx, kr, kp, kq, kz, tx, tr, tp, tq, tz
    return rows


def where_form_program(apply_a, precond, maxiter, dot=None, norm=None):
    """The standard PCG steps as they ran before the PCG update kernel:
    every vector update a new tensor (a multiply by the 0-dim scalar and an
    add), per shard on shard lists, selected by ``torch.where(active, new,
    old)``, z kept in the state. ``dot`` and ``norm``: the shard-order ones
    on shard lists (default: one device's)."""
    import torch

    from omp_amg_tpu_torch.solvers import graph as G
    from omp_amg_tpu_torch.solvers.cg import CGResult, host_copy

    dot = dot or torch.dot
    norm = norm or torch.linalg.vector_norm
    vmap = G.vmap

    def start(b, tol, x0):
        x, r = vmap(torch.zeros_like, b), vmap(torch.clone, b)
        bnorm = G.guard(norm(b))
        z = precond(r)
        rnorm = norm(r)
        hist, k = G.new_history(maxiter, rnorm)
        thr = tol * bnorm
        return dict(x=x, r=r, z=z, p=z, rz=dot(r, z), k=k,
                    active=(rnorm > thr) & (k < maxiter), hist=hist,
                    thr=thr, bnorm=bnorm)

    def step(st, masked):
        sel = G.selector(st["active"], masked)
        x, r, p, rz = st["x"], st["r"], st["p"], st["rz"]
        q = apply_a(p)
        alpha = rz / dot(p, q)
        x_n = vmap(lambda xi, pi: xi + alpha * pi, x, p)
        r_n = vmap(lambda ri, qi: ri - alpha * qi, r, q)
        z_n = precond(r_n)
        rz_n = dot(r_n, z_n)
        beta = rz_n / rz
        p_n = vmap(lambda zi, pi: zi + beta * pi, z_n, p)
        rnorm = norm(r_n)
        k, active = G.advance(st, maxiter, rnorm > st["thr"])
        G.record(st["hist"], k, rnorm, st["active"])
        return dict(st, x=sel(x_n, x), r=sel(r_n, r), z=sel(z_n, st["z"]),
                    p=sel(p_n, p), rz=sel(rz_n, rz), k=k, active=active)

    def finish(st):
        k, history, bnorm = host_copy(st, "bnorm")
        return CGResult(x=st["x"], iters=k,
                        rel_residual=float(history[-1] / bnorm),
                        history=history)

    return G.Program(start, step, finish)


class _Owner:
    """Holds the where-form's captured runner (``graph.run``'s owner)."""


def pcg_where_form_checks(counters):
    """Phase 6c: one captured standard PCG solve (to ``PCG_TOL``) on the
    benchmark cells' two 256³ paths, PMIS (host setup) and structured
    (device setup), through ``amg_pcg``, and on the z-slab path over
    ``SHARDS`` shards of the card, through ``make_dist_solver``, against
    the where-form step the kernel replaced (:func:`where_form_program`)
    captured the same way: count, history and x bit for bit;
    ``pcg_update`` launches 2 per shard and executed iteration of a
    replayed solve (frozen ones included) and the where-form none; both
    solves timed (CUDA events, warm, median of 5) and profiled."""
    import statistics

    import torch

    import omp_amg_tpu_torch as amg
    from omp_amg_tpu_torch.ops.spmv import spmv
    from omp_amg_tpu_torch.parallel.dist import (
        dist_spmv, dist_vcycle, make_dist_solver, pdot, pnorm,
    )
    from omp_amg_tpu_torch.solvers import graph as G

    a = amg.poisson3d_7pt(PCG_N)
    cube = (PCG_N,) * 3
    for label, params, grid, flavor, shards in (
            ("pmis", amg.AMGParams(coarsening="pmis"), None, "host", 0),
            ("structured", amg.AMGParams(), cube, "device", 0),
            (f"z-slab d={SHARDS}", amg.AMGParams(), cube, "host", SHARDS)):
        tag = f"pcg where-form {label} n={PCG_N}^3"
        b = amg.default_rhs(a, seed=SEED).to("cuda")
        owner = _Owner()
        if shards:
            solver = amg.AMGSolver(a, params, grid=grid, device="cuda",
                                   mesh=amg.ShardMesh(shards, "cuda"),
                                   transport="remote")
            hier, b = solver.hierarchy, solver.mesh.shard(b)
            a0 = hier.levels[0].a
            program = where_form_program(
                lambda v: dist_spmv(a0, v, shards),
                lambda r: dist_vcycle(hier, r), 100,
                dot=lambda u, v: pdot(u, v, hier.mesh),
                norm=lambda u: pnorm(u, hier.mesh))
            solve = make_dist_solver(solver.mesh, hier, tol=PCG_TOL,
                                     maxiter=100)

            def kernel():
                return solve(hier, b)
        else:
            hier = amg.amg_setup(a, params, device="cuda", grid=grid,
                                 flavor=flavor)
            a0 = hier.levels[0].a
            program = where_form_program(lambda v: spmv(a0, v),
                                         lambda r: amg.vcycle(hier, r), 100)

            def kernel():
                return amg.amg_pcg(a0, b, hier, tol=PCG_TOL, maxiter=100)

        def where_form():
            return G.run(program, b, PCG_TOL, None, owner=owner,
                         key="where-form", keep=(a0,))
        where_form(), kernel()       # the captures
        torch.cuda.synchronize()
        reset_counters(counters)
        got = kernel()
        torch.cuda.synchronize()
        mine = {k: m.launches for k, m in counters.items()}
        reset_counters(counters)
        want = where_form()
        torch.cuda.synchronize()
        theirs = {k: m.launches for k, m in counters.items()}
        blocks = -(-max(got.iters, 1) // G.BLOCK)
        expect = 2 * max(shards, 1) * G.BLOCK * blocks
        xs = got.x if shards else [got.x]
        ws = want.x if shards else [want.x]
        same = (got.iters == want.iters and got.history == want.history
                and all(torch.equal(u, v) for u, v in zip(xs, ws)))
        ms = {}
        for side, fn in (("where", where_form), ("kernel", kernel),
                         ("kernel2", kernel), ("where2", where_form)):
            ms[side] = statistics.median(
                cuda_ms(fn, reps=1, warm=0) for _ in range(5))
        print(f"{tag}: iters={got.iters} (where-form {want.iters}) history "
              f"and x bitwise the where-form's: {same}; pcg_update launches "
              f"{mine['pcg_update']} (2 x {max(shards, 1)} shards x "
              f"{G.BLOCK} x {blocks} blocks), where-form "
              f"{theirs['pcg_update']}; solve ms (events, median of 5, "
              f"where-form/kernel/kernel/where-form) {ms['where']:.3f} "
              f"{ms['kernel']:.3f} {ms['kernel2']:.3f} {ms['where2']:.3f}",
              flush=True)
        if not same:
            print(f"history {tag} kernel: "
                  + " ".join(f"{h:.9e}" for h in got.history), flush=True)
            print(f"history {tag} where-form: "
                  + " ".join(f"{h:.9e}" for h in want.history), flush=True)
            raise AssertionError(f"{tag}: the captured solve differs from "
                                 "the where-form's")
        if mine["pcg_update"] != expect or theirs["pcg_update"] != 0:
            raise AssertionError(f"{tag}: pcg_update launched "
                                 f"{mine['pcg_update']} times (expected "
                                 f"{expect}), the where-form "
                                 f"{theirs['pcg_update']}")
        profile_solve(f"{tag} kernel", None, None, run=kernel)
        profile_solve(f"{tag} where-form", None, None, run=where_form)
        del hier, owner, program, b, a0, got, want
        torch.cuda.empty_cache()


def _f64_csr(a):
    """The banded f64 operator ``a`` as a ``torch.sparse_csr_tensor`` built
    on the card (rows in order, columns ascending), for the ``torch.addmm``
    yardstick; built apart, never handed to the port."""
    import torch

    n = a.n_rows
    rows = torch.arange(n, device="cuda")[:, None]
    cols = rows + torch.tensor(a.offsets, device="cuda")[None, :]
    keep = (cols >= 0) & (cols < n)
    crow = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    crow[1:] = keep.sum(1).cumsum(0)
    return torch.sparse_csr_tensor(crow, cols[keep], a.data.t()[keep],
                                   size=(n, n))


def ir_f64_checks(rng, flush):
    """Phase 6d: the certified loop's float64 kernels at the cells' sizes,
    7-point ``IR_N``³ and 27-point ``IR27_N``³, on seeded normal f64
    planes under the stencil's offsets, against their twins (the loop's
    torch forms) on the same CUDA tensors, bit for bit: the residual r = b
    − A·x (the f64 banded kernel), the defect r / ‖r‖ in f32 (also against
    the loop's own ``(r / rnorm).float()``) and the in-place update
    x ← x + ‖r‖·x_inner.
    Bytes: the residual reads the planes, x and b and writes r; the defect
    reads r and writes f32; the update reads x and x_inner and writes x.
    Yardsticks, one torch call each: ``torch.addmm`` of the f64 CSR,
    ``torch.div`` into an f32 ``out``, ``Tensor.add_`` with ``alpha``."""
    import torch

    from omp_amg_tpu_torch.ops import ir_f64
    from omp_amg_tpu_torch.sparse.formats import Dia

    g = torch.Generator(device="cuda")
    g.manual_seed(int(rng.integers(2 ** 31)))
    rows = []
    for tag, n, reach in (("7pt", IR_N, 1), ("27pt", IR27_N, 3)):
        # the stencil's taps (dz, dy, dx) in {-1, 0, 1}³ with at most
        # ``reach`` of them nonzero, ascending
        offsets = tuple(sorted(
            dz * n * n + dy * n + dx for dz in (-1, 0, 1)
            for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            if abs(dz) + abs(dy) + abs(dx) <= reach))
        m = n ** 3
        a = Dia(data=torch.randn((len(offsets), m), dtype=torch.float64,
                                 device="cuda", generator=g),
                offsets=offsets)
        x, b, e = (torch.randn(m, dtype=torch.float64, device="cuda",
                               generator=g) for _ in range(3))
        csr = _f64_csr(a)
        xm, bm = x[:, None], b[:, None]
        r = ir_f64.residual(a, x, b)
        rnorm = float(torch.linalg.vector_norm(r))
        want = (r / rnorm).float()
        torch.cuda.synchronize()
        if not torch.equal(ir_f64.defect(r, rnorm), want):
            raise AssertionError(f"ir_f64 {tag}: the defect differs from "
                                 "the loop's (r / rnorm).float()")
        xi = e.float()
        kx, tx, lx = x.clone(), x.clone(), x.clone()
        out32 = torch.empty(m, device="cuda")
        plane_bytes = a.data.numel() * 8
        name = f"ir_f64:{tag}{n}^3"
        rows.append(compare(
            f"{name}:residual", lambda: ir_f64.residual(a, x, b),
            lambda: ir_f64.residual_twin(a, x, b), IR_BOUND,
            plane_bytes + 24 * m, flush,
            library=lambda: torch.addmm(bm, csr, xm, alpha=-1),
            flops=2 * csr._nnz()))
        rows.append(compare(
            f"{name}:defect", lambda: ir_f64.defect(r, rnorm),
            lambda: ir_f64.defect_twin(r, rnorm), IR_BOUND, 12 * m, flush,
            library=lambda: torch.div(r, rnorm, out=out32)))
        rows.append(compare(
            f"{name}:update", lambda: ir_f64.update(kx, rnorm, xi) or kx,
            lambda: ir_f64.update_twin(tx, rnorm, xi) or tx, IR_BOUND,
            20 * m, flush, library=lambda: lx.add_(xi, alpha=rnorm)))
        del a, x, b, e, csr, xm, bm, r, xi, kx, tx, lx, out32
        torch.cuda.empty_cache()
    return rows


class _Twins:
    """The certified loop with the ir_f64 twins in the kernels' place (the
    loop's torch forms), restored on exit."""

    def __enter__(self):
        from omp_amg_tpu_torch.ops import ir_f64

        self.mod = ir_f64
        self.kept = {k: getattr(ir_f64, k)
                     for k in ("residual", "defect", "update")}
        ir_f64.residual = ir_f64.residual_twin
        ir_f64.defect = ir_f64.defect_twin
        ir_f64.update = ir_f64.update_twin
        return self

    def __exit__(self, *exc):
        for k, fn in self.kept.items():
            setattr(self.mod, k, fn)


def certified_twin_checks(counters):
    """Phase 6e: one certified ``IR_N``³ 7-point solve on the structured
    path (the structured cell's device setup; the PCG captured) through the
    ir_f64 kernels, against the same solve with their twins (the loop's
    torch forms) in their place: x, inner counts, histories and the
    certified residual bit for bit; ir_f64 launches 3 per outer pass plus 1
    and the twins' none; both solves timed (CUDA events, median of 5:
    twins, kernels, kernels, twins) and profiled."""
    import statistics

    import torch

    import omp_amg_tpu_torch as amg

    a = amg.poisson3d_7pt(IR_N)
    solver = amg.AMGSolver(a, amg.AMGParams(), grid=(IR_N,) * 3,
                           device="cuda", flavor="device")
    b = amg.default_rhs(a, seed=SEED).to("cuda").double()
    tag = f"ir_f64 certified structured n={IR_N}^3"

    def kernel():
        return solver.solve(b, tol=1e-8, residual="device",
                            device_result=True)

    def twins():
        with _Twins():
            return kernel()
    kernel(), twins()                 # the capture, the first solves
    torch.cuda.synchronize()
    reset_counters(counters)
    got = kernel()
    torch.cuda.synchronize()
    mine, info = counters["ir_f64"].launches, dict(solver.last_info)
    reset_counters(counters)
    want = twins()
    torch.cuda.synchronize()
    theirs, twin_info = counters["ir_f64"].launches, dict(solver.last_info)
    keys = ("inner_iters", "outer_iters", "residual_histories",
            "rel_residual")
    same = (all(info[k] == twin_info[k] for k in keys)
            and torch.equal(got, want))
    ms = {}
    for side, fn in (("twins", twins), ("kernels", kernel),
                     ("kernels2", kernel), ("twins2", twins)):
        ms[side] = statistics.median(
            cuda_ms(fn, reps=1, warm=0) for _ in range(5))
    expect = 3 * info["outer_iters"] + 1
    print(f"{tag}: inner={info['inner_iters']} outer={info['outer_iters']} "
          f"rel={info['rel_residual']:.6e} x, counts, histories and rel "
          f"bitwise the twins': {same}; ir_f64 launches {mine} (3 x "
          f"{info['outer_iters']} + 1), twins {theirs}; solve ms (events, "
          f"median of 5, twins/kernels/kernels/twins) {ms['twins']:.3f} "
          f"{ms['kernels']:.3f} {ms['kernels2']:.3f} {ms['twins2']:.3f}",
          flush=True)
    if not same:
        histories(f"{tag} kernels", info)
        histories(f"{tag} twins", twin_info)
        raise AssertionError(f"{tag}: the solve differs from the twins'")
    if mine != expect or theirs != 0:
        raise AssertionError(f"{tag}: ir_f64 launched {mine} times "
                             f"(expected {expect}), the twins {theirs}")
    profile_solve(f"{tag} kernels", None, None, run=kernel)
    profile_solve(f"{tag} twins", None, None, run=twins)
    del solver, b, got, want
    torch.cuda.empty_cache()


def reset_counters(counters):
    for mod in counters.values():
        mod.launches = 0
        if hasattr(mod, "scalar_launches"):
            mod.scalar_launches = 0


def drive(label, a, params, grid, counters, vcycle=None, solve_kw=None,
          **kw):
    """Drive one main path through the user's entry points: counters set to
    0 just before, read just after; certified and scipy f64 residuals
    checked; then a warm solve and the cycle time (``vcycle(solver, r)``,
    default the single-device ``amg.vcycle``). ``kw`` goes to
    ``AMGSolver`` (a mesh, its transport), ``solve_kw`` to both solves (the
    PCG variant). Returns (solver, launches, run): run holds setup_s,
    setup_launches (the counters right after the setup),
    warm_solve_s, x and the solve's ``last_info``."""
    import torch

    import omp_amg_tpu_torch as amg

    solve_kw = solve_kw or {}
    b = amg.default_rhs(a, seed=SEED)
    reset_counters(counters)
    t0 = time.perf_counter()
    solver = amg.AMGSolver(a, params, grid=grid, device="cuda", **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_launches = {name: mod.launches for name, mod in counters.items()}
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
                                  setup_launches=setup_launches,
                                  warm_solve_s=warm_solve_s,
                                  vcycle_ms=vcycle_ms, scalar=scalar,
                                  scipy_rel=host_rel)


def kernel_counters() -> dict:
    """{name: module} of every kernel module of the port with a launch
    counter (``ops.kernel_modules()``)."""
    from omp_amg_tpu_torch.ops import kernel_modules

    return {m.__name__.rsplit(".", 1)[1]: m for m in kernel_modules()}


def expect_launches(label, launches, used, hier=None):
    """Every kernel in ``used`` launched, every other one not; the tiled
    CSR kernel counts as used where the path's hierarchy ``hier`` holds an
    operator in the tiled form, and must not launch elsewhere."""
    from omp_amg_tpu_torch.sparse.formats import TileCsr

    if hier is not None and any(
            isinstance(getattr(lv, name, None), TileCsr)
            for lv in hier.levels for name in ("a", "r")):
        used = (*used, "tile_csr")
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
    """``panel_spmm`` on A·PV and R·U of the first colour group (of every
    group where the level has more than two, above 256 colours) and
    ``extract_lanes`` on the whole W of level ``l``'s probe, each against
    its twin on the same CUDA tensors, with its library yardstick."""
    import torch

    from omp_amg_tpu_torch.ops import extract_lanes as ex
    from omp_amg_tpu_torch.ops import panel_spmm as ps
    from omp_amg_tpu_torch.ops import probe_rap as pr

    rows = {"panel_spmm": [], "extract_lanes": []}
    parts = []
    for k, (c0, width) in enumerate(probe.groups):
        x = pr.panel_pv(probe, c0, width)
        if k > 0 and len(probe.groups) <= 2:
            parts.append(ps.spmm_panel(probe.r, ps.spmm_panel(probe.a, x)))
            continue
        for opname, op in (("A·PV", probe.a), ("R·U", probe.r)):
            csr = library_csr(op.indptr, op.indices, op.vals, op.shape)
            name = (f"panel_spmm:L{l}-{opname}{f'-g{k}' if k else ''}:"
                    f"rows={op.n_rows}:nnz={op.nnz}:C={width}")
            spmm_instance_times(name, op, x, flush)
            rows["panel_spmm"].append(compare(
                name, lambda: ps.spmm_panel(op, x),
                lambda: ps.spmm_panel_plain(op, x), PROBE_BOUND,
                spmm_bytes(op, width), flush,
                library=lambda: torch.sparse.mm(csr, x),
                flops=2 * op.nnz * width))
            x = ps.spmm_panel(op, x)
            del csr
        parts.append(x)
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
    levels 0 and 1 and on every level of more than two colour groups.
    Returns (host record, kernel rows)."""
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
        pr.d2_color(ac)
        color_s = time.perf_counter() - t0
        line = (f"probe L{l} rows={a_sp.shape[0]} nnz_A={a_sp.nnz} "
                f"nnz_Ac={ac.nnz} host_galerkin_s={host_rap_s:.4f} "
                f"d2_color_s={color_s:.4f}")
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
        if l < 2 or len(probe.groups) > 2:
            for name, more in probe_kernel_checks(l, probe, flush).items():
                rows[name] += more
        del probe, vals
    return host, rows


def same_probe_values(label, solver, host):
    """Every coarse A of ``solver``'s hierarchy holds the values of the
    setup that ``probe_setup_checks`` checked (``host``), and every one
    came from the probe."""
    import torch

    from omp_amg_tpu_torch.amg import hierarchy

    for l, lv in enumerate(solver.hierarchy.levels[1:], 1):
        want = torch.from_numpy(host.ops[l].data.astype(np.float32))
        if not torch.equal(lv.a.vals.cpu(), want.to(lv.a.vals.dtype)):
            raise AssertionError(f"{label}: level {l}'s A differs from the "
                                 "checked setup's")
    engines = solver.hierarchy.rap_engines
    print(f"{label} rap_engines={engines} rap_products="
          f"{dict(hierarchy.rap_products)}", flush=True)
    if engines != ("probe",) * len(solver.hierarchy.levels):
        raise AssertionError(f"{label}: not every product was probed: "
                             f"{engines}")


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
    ms = cuda_ms(lambda: pr.rap_probe_numeric(probe), reps=5, warm=1)
    print(f"rap_bench n={n}^3 L0 nnz_A={a0.nnz} colours={probe.n_colors} "
          f"rap_probe_ms={ms:.4f} "
          f"rap_probe_gnnz_per_s={a0.nnz / ms / 1e6:.4f} "
          f"host_galerkin_s={host_s:.4f} "
          f"host_gnnz_per_s={a0.nnz / host_s / 1e9:.4f}", flush=True)


def profile_solve(label, solver, b, top=8, run=None, **solve_kw):
    """One warm certified solve (``solve_kw``: more ``solve`` arguments),
    or the call ``run``, under ``torch.profiler``: wall seconds, device busy
    milliseconds (the
    profiler's "Self CUDA time total": the self device time of the device
    events) and their share of the wall, and the ``top`` device items by
    time. Returns (wall seconds, busy milliseconds)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if run is None:
            solver.solve(b, tol=1e-8, **solve_kw)
        else:
            run()
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
    return wall, busy_ms


def halo_row(tag, srcs, nl, nr, flush):
    """``remote_halo_window`` on the shards ``srcs`` with halo widths
    ``nl``, ``nr``: its path held against the launch counters, then
    kernel against twin, with one ``torch.cat`` of the windows' parts (the
    two zero strips made beforehand) as the library yardstick. The row's
    name ends in the path taken."""
    import torch

    from omp_amg_tpu_torch.ops import remote_halo as rh

    d, n_loc = len(srcs), srcs[0].numel()
    vec = rh.vector_path(srcs, n_loc, nl, nr)
    name = (f"remote_halo:{tag}:d={d}:n_loc={n_loc}:nl={nl}:nr={nr}:"
            f"path={'vector' if vec else 'scalar'}")

    def window():
        return rh.remote_halo_window(srcs, nl, nr)
    expect_path(rh, name, window, vec)
    parts = []
    for i, x in enumerate(srcs):
        parts += [srcs[i - 1][n_loc - nl:] if i else x.new_zeros(nl), x,
                  srcs[i + 1][:nr] if i < d - 1 else x.new_zeros(nr)]
    # bytes: every window written, every part read but the zero strips
    nbytes = 4 * d * (nl + n_loc + nr) + 4 * (d * n_loc + (d - 1) * (nl + nr))
    return compare(name, window,
                   lambda: rh.remote_halo_window_plain(srcs, nl, nr),
                   HALO_BOUND, nbytes, flush,
                   library=lambda: torch.cat(parts),
                   flat=lambda w: w.reshape(-1))


def sharded_path(n, counters, flush, rng):
    """Phase 10: the z-slab distributed path (module docstring); returns
    (launches of its main-path run, that run, kernel rows)."""
    import torch

    import omp_amg_tpu_torch as amg
    from omp_amg_tpu_torch.ops import dia_spmv
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
    expect_launches("sharded", launches,
                    ("dia_spmv", "remote_halo", "grid_transfer",
                     "pcg_update", "ir_f64"))
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
        row = halo_row(tag, srcs, nl, nr, flush)
        rows["remote_halo"].append(row)
        name, path = row["name"], row["name"].rsplit("=", 1)[1]
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
    from omp_amg_tpu_torch.sparse.formats import tile_to_csr

    lv0, lv1 = hier.levels[0], hier.levels[1]
    rows = {"dia_spmv": dia_checks("P27-L0-A", lv0.a, lv0.s, rng, flush,
                                   (lv0.a.data.dtype,)),
            "csr_spmv": []}
    dev = hier.device
    for opname, op in (("A", tile_to_csr(lv1.a)), ("P", lv1.p),
                       ("R", tile_to_csr(lv1.r))):
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
    beside the TPU records; then the PMIS pipeline with the device Galerkin
    product (``rap="probe"``, the parameters of the benchmark's
    ``pmis27_128_cheby``): phase 5a's checks on its setup, whose levels 2
    and 3 need more than 256 colours, its counts beside the host-valued
    setup's, and its solve timed as the benchmark's cell times it
    (:func:`cell_times`). Returns ({path: launches}, kernel rows)."""
    import omp_amg_tpu_torch as amg
    from omp_amg_tpu_torch.amg import hierarchy

    a = amg.poisson3d_27pt(CHEBY_N)
    grid = (CHEBY_N,) * 3
    paths, rows, counts = {}, {}, {}
    for pipeline, params, g, used in (
            ("structured", amg.AMGParams(smoother="chebyshev"), grid,
             ("const_stencil", "dia_spmv", "grid_transfer", "pcg_update",
              "ir_f64")),
            ("pmis", amg.AMGParams(coarsening="pmis", smoother="chebyshev"),
             None, ("dia_spmv", "csr_spmv", "pcg_update", "ir_f64")),
            ("pmis probe", amg.AMGParams(coarsening="pmis",
                                         smoother="chebyshev", rap="probe"),
             None, ("dia_spmv", "csr_spmv", "panel_spmm", "extract_lanes",
                    "pcg_update", "ir_f64"))):
        label = f"cheby {pipeline} 27pt n={CHEBY_N}^3"
        if pipeline == "pmis probe":
            host, more = probe_setup_checks(a, params, flush)
            rows.update(more)
            host_products = hierarchy.rap_products["host"]
        solver, launches, run = drive(label, a, params, g, counters)
        expect_launches(label, launches, used, hier=solver.hierarchy)
        info = run["info"]
        check_certified(label, info, run["scipy_rel"])
        rec = TPU_RECORD_CHEBY[pipeline.split()[0]]
        got = (sum(info["inner_iters"]), info["outer_iters"])
        counts[pipeline] = got
        print(f"{label} inner={got[0]} ({info['inner_iters']}) "
              f"outer={got[1]} | TPU record (bench_details.json) "
              f"inner={rec[0]} outer={rec[1]}"
              f"{'' if got == rec else ' DIFFERS'}", flush=True)
        if got != rec:
            histories(label, info)
        if pipeline == "pmis":
            rows.update(pmis27_kernel_checks(solver.hierarchy, rng, flush))
        if pipeline == "pmis probe":
            same_probe_values(label, solver, host)
            if hierarchy.rap_products["host"] != host_products:
                raise AssertionError(f"{label}: a product took host values")
            print(f"{label} vs cheby pmis: inner, outer {got} vs "
                  f"{counts['pmis']}"
                  f"{'' if got == counts['pmis'] else ' DIFFERS'}",
                  flush=True)
            cell_times(label, solver, a, run, flush)
            del host
        paths[f"cheby_{pipeline.replace(' ', '_')}"] = launches
        del solver
    return paths, rows


def cell_times(label, solver, a, run, flush, reps=GRAPH_RUNS):
    """``drive``'s warm solve (b and x on the host, one solve on the wall
    clock) and V-cycle (the eager ``amg.vcycle``, its CUDA events taking
    in the host's enqueue) beside the benchmark's way of timing the same
    solver (``bench_port``'s ``solve`` traffic): warm solves with b on the
    card and x left there (``device_result=True``) between CUDA events,
    and the preconditioner as the captured loop applies it,
    ``solver.precondition`` captured in a CUDA graph and replayed with a
    cold L2; the medians of ``reps`` solves, each way."""
    import gc
    import statistics

    import torch

    import omp_amg_tpu_torch as amg

    b = amg.default_rhs(a, seed=SEED)
    b_card = b.to("cuda")
    kw = {"tol": 1e-8, "residual": "device"}

    def walls(rhs, **more):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver.solve(rhs, **kw, **more)
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(out)

    def events(rhs, **more):
        out = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            solver.solve(rhs, **kw, **more)
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return statistics.median(out)

    solver.solve(b_card, **kw, device_result=True)   # its graphs captured
    host_wall = walls(b)
    card_wall = walls(b_card, device_result=True)
    card_events = events(b_card, device_result=True)

    r = b_card
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            solver.precondition(r)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            solver.precondition(r)
    finally:
        gc.enable()
    eager_cold = cuda_ms(lambda: solver.precondition(r), flush=flush)
    graph_cold = cuda_ms(graph.replay, flush=flush)
    print(f"{label} timed two ways: drive warm_solve_ms="
          f"{1e3 * run['warm_solve_s']:.3f} (one solve, b and x on the "
          f"host); median of {reps}: b and x on the host wall_ms="
          f"{host_wall:.3f}, b and x on the card wall_ms={card_wall:.3f} "
          f"events_ms={card_events:.3f} (the cell's solve_ms) | V-cycle: "
          f"drive eager vcycle_ms={run['vcycle_ms']:.4f}, eager cold L2 "
          f"{eager_cold:.4f}, captured cold L2 {graph_cold:.4f} (the "
          f"cell's vcycle_ms.solve)", flush=True)
    del graph


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
                if not launches["pcg_update"]:
                    raise AssertionError(f"{label}: no pcg_update launch")
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
                expect_launches(label, launches,
                                ("dia_spmv", "remote_halo", "grid_transfer",
                                 "pcg_update", "ir_f64"))
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


def hier_tensors(h):
    """[(name, tensor)] of every device tensor of a serial hierarchy."""
    import dataclasses

    import torch

    out = [("coarse_chol", h.coarse_chol)]
    for l, lv in enumerate(h.levels):
        for name in ("s", "dinv_dev"):
            v = getattr(lv, name)
            if isinstance(v, torch.Tensor):
                out.append((f"L{l}.{name}", v))
        for name in ("a", "p", "r"):
            op = getattr(lv, name)
            for f in dataclasses.fields(op):
                v = getattr(op, f.name)
                if isinstance(v, torch.Tensor):
                    out.append((f"L{l}.{name}.{f.name}", v))
    return out


def h2d_bytes(h, old=None) -> int:
    """Bytes of ``h``'s device tensors that crossed from the host: every
    tensor of a fresh setup; of a refresh of ``old``, those it does not
    share with ``old``, less R's values (gathered from P's on the card)."""
    shared = {t.data_ptr() for _, t in hier_tensors(old)} if old else set()
    return sum(t.numel() * t.element_size() for name, t in hier_tensors(h)
               if t.data_ptr() not in shared
               and not (old is not None and name.endswith(".r.vals")))


def refresh_value_error(h, want) -> float:
    """The largest relative value error of ``h`` against ``want`` (same
    structure required): per operator max|Δ| / max|want|, and per entry
    for dinv."""
    import torch

    from omp_amg_tpu_torch.sparse.formats import Csr, TileCsr

    if len(h.levels) != len(want.levels):
        raise AssertionError("refresh: level count differs from fresh")
    worst = 0.0
    for l, (lg, lw) in enumerate(zip(h.levels, want.levels)):
        worst = max(worst, float(np.max(np.abs(lg.dinv - lw.dinv)
                                        / np.abs(lw.dinv))))
        for name in ("a", "p", "r"):
            og, ow = getattr(lg, name), getattr(lw, name)
            if isinstance(ow, (Csr, TileCsr)):
                if not (torch.equal(og.indptr, ow.indptr)
                        and torch.equal(og.indices, ow.indices)):
                    raise AssertionError(f"refresh: L{l} {name}'s pattern "
                                         "differs from the fresh setup's")
                vg, vw = og.vals, ow.vals
            else:
                vg, vw = og.data, ow.data
            if vg.dtype != vw.dtype or vg.shape != vw.shape:
                raise AssertionError(f"refresh: L{l} {name}'s value type or "
                                     "shape differs from the fresh setup's")
            worst = max(worst, float((vg.double() - vw.double()).abs().max()
                                     / vw.double().abs().max()))
    return worst


def refresh_paths(counters):
    """Phase 12a: bench.py's refresh128 (27-point 128³ PMIS Chebyshev with
    a SetupCache; ×2.0 cold and ×0.5 warm refreshes; PCG on the ×0.5
    operator beside a fresh setup of it and the TPU record), then the
    facade's refresh by the non-dyadic ×1.7 on the 7-point 128³ PMIS path
    and its certified solve beside a fresh solver's. Returns {path:
    launches}."""
    import warnings

    import torch

    import omp_amg_tpu_torch as amg

    def scaled(a, s):
        return amg.Dia(data=a.data * s, offsets=a.offsets, dims=a.dims)

    def read():
        return {name: mod.launches for name, mod in counters.items()}

    n = REFRESH_N
    params = amg.AMGParams(coarsening="pmis", smoother="chebyshev")
    a = amg.poisson3d_27pt(n)
    cache = amg.SetupCache()
    reset_counters(counters)
    t0 = time.perf_counter()
    h0 = amg.amg_setup(a, params, device="cuda", cache=cache)
    torch.cuda.synchronize()
    fresh_s = time.perf_counter() - t0
    times, hiers = [], []
    for s in (2.0, 0.5):
        t0 = time.perf_counter()
        hiers.append(amg.amg_refresh(scaled(a, s), cache))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    h = hiers[-1]
    a5 = scaled(a, 0.5)
    b = amg.default_rhs(a5, seed=SEED).to("cuda")
    res = amg.amg_pcg(h.levels[0].a, b, h, tol=1e-6, maxiter=100)
    torch.cuda.synchronize()
    launches = read()
    expect_launches("refresh128", launches,
                    ("dia_spmv", "csr_spmv", "pcg_update"), hier=h)
    shared = all(
        getattr(lv, name).indptr.data_ptr()
        == getattr(l0, name).indptr.data_ptr()
        and getattr(lv, name).indices.data_ptr()
        == getattr(l0, name).indices.data_ptr()
        for l0, lv in zip(h0.levels, h.levels) for name in ("p", "r")) and all(
        lv.a.indices.data_ptr() == l0.a.indices.data_ptr()
        for l0, lv in zip(h0.levels[1:], h.levels[1:]))
    warm_bytes = h2d_bytes(h, hiers[0])
    fresh_bytes = h2d_bytes(h0)
    cache_mb = amg.cache_nbytes(cache) / 1e6
    del hiers, h0
    hf = amg.amg_setup(a5, params, device="cuda")
    err = refresh_value_error(h, hf)
    res_f = amg.amg_pcg(hf.levels[0].a, b, hf, tol=1e-6, maxiter=100)
    print(f"refresh128 27pt n={n}^3 fresh_setup_s={fresh_s:.3f} "
          f"cold_s={times[0]:.3f} warm_s={times[1]:.3f} "
          f"cache_mb={cache_mb:.1f} warm_h2d_mb={warm_bytes / 1e6:.2f} "
          f"fresh_h2d_mb={fresh_bytes / 1e6:.2f} "
          f"max_rel_value_err={err:.3e} index_tensors_shared={shared} "
          f"pcg_iters refreshed={res.iters} fresh={res_f.iters} | TPU record "
          f"(bench_details.json refresh_warm_iters) {TPU_RECORD_REFRESH} | "
          f"rel={res.rel_residual:.3e} "
          f"launches={ {k: v for k, v in launches.items() if v} }",
          flush=True)
    if err > REFRESH_BOUND:
        raise AssertionError(f"refresh128: refreshed values {err:.3e} from "
                             f"the fresh setup's (> {REFRESH_BOUND:g})")
    if not shared:
        raise AssertionError("refresh128: an index tensor was not shared "
                             "with the cached hierarchy")
    if res.iters != res_f.iters or res.rel_residual > 1e-6:
        raise AssertionError(f"refresh128: refreshed PCG {res.iters} "
                             f"iterations, fresh {res_f.iters}")
    del h, hf, cache
    paths = {"refresh128": launches}

    # the facade: refresh by a non-dyadic factor, then a certified solve
    n7 = REFRESH_SOLVER_N
    a7 = amg.poisson3d_7pt(n7)
    a17 = scaled(a7, 1.7)
    b17 = amg.default_rhs(a17, seed=SEED)
    label = f"refresh x1.7 pmis n={n7}^3"
    reset_counters(counters)
    t0 = time.perf_counter()
    solver = amg.AMGSolver(a7, amg.AMGParams(coarsening="pmis"),
                           device="cuda", refreshable=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        solver.refresh(a17)
        torch.cuda.synchronize()
        refresh_s = time.perf_counter() - t0
    x = solver.solve(b17, tol=1e-8)
    launches = read()
    info = dict(solver.last_info)
    b64 = b17.numpy().astype(np.float64)
    rel = float(np.linalg.norm(b64 - amg.dia_to_scipy(a17) @ x)
                / np.linalg.norm(b64))
    fresh = amg.AMGSolver(a17, amg.AMGParams(coarsening="pmis"),
                          device="cuda")
    fresh.solve(b17, tol=1e-8)
    fi = fresh.last_info
    tripped = [str(w.message) for w in caught
               if "pattern guard" in str(w.message)]
    print(f"{label} setup_s={setup_s:.3f} refresh_s={refresh_s:.3f} "
          f"inner={info['inner_iters']} outer={info['outer_iters']} "
          f"certified={info['rel_residual']:.3e} scipy={rel:.3e} "
          f"residual={info['residual']} | fresh inner={fi['inner_iters']} "
          f"outer={fi['outer_iters']} | pattern guard warnings={tripped} "
          f"launches={ {k: v for k, v in launches.items() if v} }",
          flush=True)
    expect_launches(label, launches, ("dia_spmv", "csr_spmv", "pcg_update",
                                      "ir_f64"), hier=solver.hierarchy)
    check_certified(label, info, rel)
    if tripped:
        raise AssertionError(f"{label}: the refresh fell back to a fresh "
                             "setup")
    if (info["inner_iters"], info["outer_iters"]) != (fi["inner_iters"],
                                                      fi["outer_iters"]):
        histories(f"{label} refreshed", info)
        histories(f"{label} fresh", fi)
        raise AssertionError(f"{label}: counts differ from a fresh solver's")
    paths["refresh_x17"] = launches
    return paths


def cli_paths(counters):
    """Phase 12b: the CLI on the card, in process (launch counters read
    around each run): the structured default, PMIS with
    --save-hierarchy, then --load-hierarchy (equal iters; the loaded
    tensors bitwise the saved ones), --matrix on a MatrixMarket file; then
    one ``python -m omp_amg_tpu_torch.cli`` subprocess. Returns {path:
    launches}."""
    import contextlib
    import io
    import os
    import tempfile

    import torch

    import omp_amg_tpu_torch as amg
    from omp_amg_tpu_torch import cli
    from omp_amg_tpu_torch.utils import io as amg_io

    def report(label, summary, launches=None):
        used = ("" if launches is None else
                f" launches={ {k: v for k, v in launches.items() if v} }")
        print(f"cli {label}: iters={summary['iters']} "
              f"true_rel_residual={summary['true_rel_residual']:.3e} "
              f"levels={summary['levels']} sizes={summary['sizes']} "
              f"timers_s={json.dumps(summary['timers_s'])} "
              f"spmv_gnnz_per_s={summary['spmv_gnnz_per_s']:.4f} "
              f"backend={summary['backend']}{used}", flush=True)
        if summary["backend"] != "cuda" or \
                summary["true_rel_residual"] > 1e-8:
            raise AssertionError(f"cli {label}: not certified on the card")

    def run(label, args, used, hier=lambda: None):
        reset_counters(counters)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(args + ["--json"])
        torch.cuda.synchronize()
        launches = {name: mod.launches for name, mod in counters.items()}
        if rc != 0:
            raise AssertionError(f"cli {label}: exit code {rc}")
        summary = json.loads(out.getvalue().strip().splitlines()[-1])
        report(label, summary, launches)
        expect_launches(f"cli {label}", launches, used, hier=hier())
        return summary, launches

    n = CLI_N
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        _, paths["cli_structured"] = run(
            f"3d7pt n={n}", ["--problem", "3d7pt", "--n", str(n)],
            ("const_stencil", "dia_spmv", "grid_transfer", "pcg_update",
             "ir_f64"))

        # PMIS, saved; the saved hierarchy captured for the bitwise check
        h_path = os.path.join(tmp, "h.npz")
        saved = {}
        save = amg_io.save_hierarchy

        def capture(path, hier):
            saved["hier"] = hier
            save(path, hier)
        pmis = ["--problem", "3d7pt", "--n", str(n), "--coarsening", "pmis"]
        amg_io.save_hierarchy = capture
        try:
            first, paths["cli_pmis_save"] = run(
                f"3d7pt n={n} pmis --save-hierarchy",
                pmis + ["--save-hierarchy", h_path],
                ("dia_spmv", "csr_spmv", "pcg_update", "ir_f64"),
                hier=lambda: saved["hier"])
        finally:
            amg_io.save_hierarchy = save
        back = amg.load_hierarchy(h_path, device="cuda")
        loaded, paths["cli_pmis_load"] = run(
            f"3d7pt n={n} pmis --load-hierarchy",
            pmis + ["--load-hierarchy", h_path],
            ("dia_spmv", "csr_spmv", "pcg_update", "ir_f64"),
            hier=lambda: back)
        want = dict(hier_tensors(saved.pop("hier")))
        got = dict(hier_tensors(back))
        same = sorted(got) == sorted(want) and all(
            got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
            for k in want)
        print(f"cli save/load: iters {first['iters']} / {loaded['iters']}; "
              f"{len(want)} device tensors, loaded bitwise the saved: {same}",
              flush=True)
        if not same or loaded["iters"] != first["iters"]:
            raise AssertionError("cli: the loaded hierarchy differs from the "
                                 "saved one")
        del want, got

        m_path = os.path.join(tmp, "a.mtx")
        amg.write_matrix_market(m_path, amg.poisson3d_7pt(CLI_MATRIX_N))
        _, paths["cli_matrix"] = run(f"--matrix 3d7pt n={CLI_MATRIX_N}",
                                     ["--matrix", m_path],
                                     ("csr_spmv", "pcg_update"))

    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "omp_amg_tpu_torch.cli", "--problem", "3d7pt",
         "--n", str(n), "--json"], cwd=root, capture_output=True, text=True,
        timeout=600)
    if proc.returncode != 0:
        print(proc.stderr[-3000:], file=sys.stderr)
        raise AssertionError(f"cli subprocess: exit code {proc.returncode}")
    report(f"subprocess 3d7pt n={n}",
           json.loads(proc.stdout.strip().splitlines()[-1]))
    return paths


def pmis_window_checks(dh, rng, flush):
    """Phase 13a's kernel rows: ``csr_spmv`` on shard 1 of the sharded
    PMIS hierarchy's L0 and L1 A, over its exchanged window (spmv,
    residual, jacobi with ``x_base``), and ``remote_halo_window`` at their
    halo widths (h = one 128² plane at L0, an odd width at L1: the scalar
    path). Returns rows per kernel."""
    import torch

    from omp_amg_tpu_torch.ops import csr_spmv
    from omp_amg_tpu_torch.parallel.dist import DistOp, _windows

    rows = {"csr_spmv": [], "remote_halo": []}
    for l in (0, 1):
        lv = dh.levels[l]
        op = lv.a
        if not (isinstance(op, DistOp) and op.mode == "halo"):
            raise AssertionError(f"pmis mesh L{l}: A is not in halo mode")
        xs = [_vec(rng, op.m_in, "cuda") for _ in op.blocks]
        rows["remote_halo"].append(halo_row(f"PM-L{l}", xs, op.halo,
                                            op.halo, flush))
        # csr_spmv on shard 1's window
        w, base = _windows(op, xs)[1]
        blk, s1 = op.blocks[1], lv.s[1]
        if w.numel() >= 1 << 31:
            raise AssertionError("window beyond int32 columns")
        nr = blk.n_rows
        b1 = _vec(rng, nr, "cuda")
        csr = library_csr(blk.indptr, blk.indices, blk.vals, blk.shape)
        cb = (blk.nnz * (4 + blk.vals.element_size()) + 8 * (nr + 1)
              + 4 * w.numel() + 4 * nr)
        cases = {
            "spmv": (lambda: csr_spmv.spmv(blk, w),
                     lambda: csr_spmv.csr_spmv_plain(blk, w), cb,
                     library_spmv(csr, w)),
            "residual": (lambda: csr_spmv.residual(blk, w, b1),
                         lambda: csr_spmv.csr_spmv_plain(blk, w, "residual",
                                                         b=b1),
                         cb + 4 * nr, library_addmm(csr, w, b1, -1)),
            "jacobi": (lambda: csr_spmv.jacobi(blk, w, b1, s1, x_base=base),
                       lambda: csr_spmv.csr_spmv_plain(
                           blk, w, "jacobi", b=b1, s=s1, x_base=base),
                       cb + 8 * nr, None),
        }
        vt = "bf16" if blk.vals.dtype == torch.bfloat16 else "f32"
        for mode, (kern, plain, nbytes, library) in cases.items():
            rows["csr_spmv"].append(compare(
                f"csr_spmv:PM-L{l}-A-shard1:{vt}:window-{mode}:rows={nr}:"
                f"nnz={blk.nnz}:x_len={w.numel()}:h={op.halo}:V={blk.vec}",
                kern,
                plain, CSR_BOUND, nbytes, flush, library=library,
                flops=2 * blk.nnz))
        del csr, xs, w
    return rows


def certified_counts(dh, mesh, a, b):
    """The certified solve of ``b`` on a sharded hierarchy through
    ``make_dist_ir_solver``, against the f64 operator ``a``. Returns (inner
    counts, outer count, certified rel, x)."""
    from omp_amg_tpu_torch.parallel.dist_ir import (
        fine_f64, make_dist_ir_solver,
    )
    from omp_amg_tpu_torch.parallel.partition import pad_vector

    b64 = b.numpy().astype(np.float64)
    res = make_dist_ir_solver(mesh, dh, fine_f64(a, dh, mesh.device),
                              tol=1e-8, maxiter=500)(
        dh, pad_vector(b64, dh, mesh.size))
    return (list(res.inner_iters), res.outer_iters, res.rel_residual,
            res.x[:a.n_rows])


def pmis_mesh_path(n, counters, flush, rng):
    """Phase 13: the row-sharded PMIS path on one card (module docstring).
    Returns ({path: launches}, the 13a run, kernel rows, the 13c fresh
    solver of 2.0·A, which phase 14 reuses)."""
    import warnings

    import torch

    import omp_amg_tpu_torch as amg
    from omp_amg_tpu_torch.amg import host_setup as hs
    from omp_amg_tpu_torch.ops import csr_spmv, remote_halo
    from omp_amg_tpu_torch.parallel.partition import (
        partition_hierarchy, place_hierarchy, with_transport,
    )

    pmis = amg.AMGParams(coarsening="pmis")
    paths = {}

    def scaled(a, s):
        return amg.Dia(data=a.data * s, offsets=a.offsets, dims=a.dims)

    def precondition(solver, r):
        return solver.precondition(r)

    # 13a: the main path
    a = amg.poisson3d_7pt(n)
    b = amg.default_rhs(a, seed=SEED)
    mesh = amg.ShardMesh(SHARDS, "cuda")
    label = f"pmis mesh d={SHARDS} remote n={n}^3"
    solver, launches, run = drive(label, a, pmis, None, counters,
                                  vcycle=precondition, mesh=mesh,
                                  transport="remote", refreshable=True)
    expect_launches(label, launches,
                    ("csr_spmv", "remote_halo", "pcg_update"),
                    hier=solver.hierarchy)
    paths["pmis_mesh"] = launches
    dh = solver.hierarchy
    print(f"{label} stats={solver.stats()} modes="
          f"{[getattr(lv.a, 'mode', 'replicated') for lv in dh.levels]} "
          f"halos={[getattr(lv.a, 'halo', 0) for lv in dh.levels]} "
          f"remote_halo_scalar_launches={run['scalar']['remote_halo']} of "
          f"{launches['remote_halo']}", flush=True)
    info = run["info"]
    reset_counters(counters)
    solver.solve(b, tol=1e-8)
    torch.cuda.synchronize()
    per = {"csr_spmv": csr_spmv.launches,
           "remote_halo": remote_halo.launches}
    iters = sum(solver.last_info["inner_iters"])
    print(f"{label} launches per warm solve ({iters} PCG iterations, "
          f"{solver.last_info['outer_iters']} outer): csr_spmv="
          f"{per['csr_spmv']} remote_halo={per['remote_halo']} "
          f"(scalar path {remote_halo.scalar_launches})", flush=True)
    profile_solve(label, solver, b)
    rows = pmis_window_checks(dh, rng, flush)

    # 13b: parity. The ppermute transport on the same hierarchy: bitwise
    got = certified_counts(with_transport(dh, "ppermute"), mesh, a, b)
    if not np.array_equal(got[3], run["x"]) or (got[0], got[1]) != (
            info["inner_iters"], info["outer_iters"]):
        raise AssertionError("pmis mesh: the ppermute solve differs from "
                             "the remote one")
    print(f"{label} ppermute == remote: x bitwise equal, inner {got[0]} "
          f"outer {got[1]}", flush=True)

    # 13c: the distributed refresh on the 13a solver, ×2.0
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        solver.refresh(scaled(a, 2.0))
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    tripped = [str(w.message) for w in caught
               if "pattern guard" in str(w.message)]
    x2 = solver.solve(b, tol=1e-8)
    ri = dict(solver.last_info)
    b64 = b.numpy().astype(np.float64)
    rel2 = float(np.linalg.norm(b64 - amg.dia_to_scipy(scaled(a, 2.0)) @ x2)
                 / np.linalg.norm(b64))
    del solver
    t0 = time.perf_counter()
    fresh = amg.AMGSolver(scaled(a, 2.0), pmis, mesh=mesh, device="cuda",
                          transport="remote")
    torch.cuda.synchronize()
    fresh_s = time.perf_counter() - t0
    fresh.solve(b, tol=1e-8)
    fi = fresh.last_info
    print(f"pmis mesh refresh x2.0 n={n}^3 setup_s={run['setup_s']:.3f} "
          f"refresh_s={refresh_s:.3f} fresh_setup_s={fresh_s:.3f} inner="
          f"{ri['inner_iters']} outer={ri['outer_iters']} certified="
          f"{ri['rel_residual']:.3e} scipy={rel2:.3e} | fresh inner="
          f"{fi['inner_iters']} outer={fi['outer_iters']} | pattern guard "
          f"warnings={tripped}", flush=True)
    check_certified("pmis mesh refresh x2.0", ri, rel2)
    if tripped:
        raise AssertionError("pmis mesh refresh x2.0 fell back to a setup")
    if (ri["inner_iters"], ri["outer_iters"]) != (fi["inner_iters"],
                                                  fi["outer_iters"]):
        raise AssertionError("pmis mesh refresh x2.0: counts differ from "
                             "a fresh solver's")

    # 13b (continued) at PARITY_N³: keep_host bitwise on 1, 2, 4 shards,
    # the certified counts of 1, 2, 4 shards and of the central route
    n2 = PARITY_N
    a2 = amg.poisson3d_7pt(n2)
    b2 = amg.default_rhs(a2, seed=SEED)
    hosts, counts = {}, {}
    for d in (1, 2, SHARDS):
        m = amg.ShardMesh(d, "cuda")
        dh_d, hosts[d] = amg.dist_pmis_setup(a2, d, pmis, mesh=m,
                                             transport="remote",
                                             keep_host=True)
        counts[d] = certified_counts(dh_d, m, a2, b2)[:3]
        del dh_d
    for d in (2, SHARDS):
        for l, (u, v) in enumerate(zip(hosts[1].levels, hosts[d].levels)):
            for key in ("a", "p", "r"):
                if not all(np.array_equal(x, y)
                           for x, y in zip(u[key][:2], v[key][:2])):
                    raise AssertionError(f"pmis mesh keep_host: L{l} {key} "
                                         f"differs between 1 and {d} shards")
            if not (np.array_equal(u["dinv"], v["dinv"])
                    and u["lmax"] == v["lmax"]
                    and np.array_equal(u["state"], v["state"])):
                raise AssertionError(f"pmis mesh keep_host: L{l} differs "
                                     f"between 1 and {d} shards")
        if not all(np.array_equal(u.data, v.data)
                   for u, v in zip(hosts[1].ops, hosts[d].ops)):
            raise AssertionError(f"pmis mesh keep_host: A_c differs between "
                                 f"1 and {d} shards")
    print(f"pmis mesh n={n2}^3 keep_host hierarchy bitwise equal on 1, 2 "
          f"and {SHARDS} shards ({len(hosts[1].levels)} levels)", flush=True)
    del hosts
    hier = amg.amg_setup(a2, pmis, device="cuda")
    dh_c = place_hierarchy(partition_hierarchy(hier, SHARDS,
                                               transport="remote"), mesh)
    del hier
    counts["central"] = certified_counts(dh_c, mesh, a2, b2)[:3]
    del dh_c
    print(f"pmis mesh n={n2}^3 certified counts: " + " ".join(
        f"{k}: inner={v[0]} outer={v[1]} rel={v[2]:.3e}"
        for k, v in counts.items()), flush=True)
    first = counts[1][:2]
    for k, v in counts.items():
        if v[:2] != first or v[2] > 1e-8:
            raise AssertionError(f"pmis mesh n={n2}^3: {k}'s counts differ "
                                 "from 1 shard's")
    # 13c (continued): the non-dyadic ×1.7 refresh with its tie repair
    repaired = []
    real = hs.extpi_pinned_rows

    def counting(*args):
        repaired.append(len(args[6]))
        return real(*args)
    s = amg.AMGSolver(a2, pmis, mesh=mesh, device="cuda",
                      transport="remote", refreshable=True)
    hs.extpi_pinned_rows = counting
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            s.refresh(scaled(a2, 1.7))
    finally:
        hs.extpi_pinned_rows = real
    x17 = s.solve(b2, tol=1e-8)
    b2_64 = b2.numpy().astype(np.float64)
    rel17 = float(np.linalg.norm(
        b2_64 - amg.dia_to_scipy(scaled(a2, 1.7)) @ x17)
        / np.linalg.norm(b2_64))
    tripped = [str(w.message) for w in caught
               if "pattern guard" in str(w.message)]
    print(f"pmis mesh refresh x1.7 n={n2}^3 repaired_rows={repaired} "
          f"inner={s.last_info['inner_iters']} "
          f"outer={s.last_info['outer_iters']} certified="
          f"{s.last_info['rel_residual']:.3e} scipy={rel17:.3e} pattern "
          f"guard warnings={tripped}", flush=True)
    check_certified("pmis mesh refresh x1.7", s.last_info, rel17)
    if tripped or not repaired:
        raise AssertionError("pmis mesh refresh x1.7: no tie repair, or a "
                             "fallback to a fresh setup")
    del s
    # the GPU/CPU iteration parity of the path
    parity(f"pmis mesh d={SHARDS} n={SHARD_PARITY_N}^3",
           amg.poisson3d_7pt(SHARD_PARITY_N), pmis, None, shards=SHARDS,
           transport="remote", agg_rows_per_dev=512)

    # 13d: the certified residual is the user's f64 operator's
    n3 = STEP0_N
    a3 = scaled(amg.poisson3d_7pt(n3), 1.7)
    b3 = amg.default_rhs(a3, seed=SEED)
    b3_64 = b3.numpy().astype(np.float64)
    for tag, kw in (("z-slab", dict(params=amg.AMGParams(),
                                    grid=(n3,) * 3)),
                    ("pmis", dict(params=pmis, agg_rows_per_dev=512))):
        s = amg.AMGSolver(a3, mesh=mesh, device="cuda", transport="remote",
                          **kw)
        x = s.solve(b3, tol=1e-8)
        rel = float(np.linalg.norm(b3_64 - amg.dia_to_scipy(a3) @ x)
                    / np.linalg.norm(b3_64))
        print(f"f64 certificate {tag} n={n3}^3 x1.7: certified="
              f"{s.last_info['rel_residual']:.3e} scipy={rel:.3e} inner="
              f"{s.last_info['inner_iters']} outer="
              f"{s.last_info['outer_iters']}", flush=True)
        check_certified(f"f64 certificate {tag}", s.last_info, rel)
        del s
    return paths, run, rows, fresh


def graph_totals(owner, keys) -> dict:
    """The captured-block runners' stats on ``owner`` (a hierarchy),
    summed over the runners keyed in ``keys``."""
    from omp_amg_tpu_torch.solvers.graph import graph_stats

    tot = {"capture_s": 0.0, "pool_bytes": 0, "blocks": 0, "frozen": 0,
           "enqueue_s": 0.0, "solves": 0, "path_changed": False}
    for key, st in graph_stats(owner).items():
        if key in keys:
            for k in tot:
                tot[k] = (tot[k] | st[k] if k == "path_changed"
                          else tot[k] + st[k])
    return tot


def replay_ms(owner, keys):
    """Device milliseconds of one replay of the start and the block graph
    of each runner keyed in ``keys`` on ``owner`` (CUDA events, warm, the
    L2 as the solve leaves it): [(start ms, block ms)]."""
    return [(cuda_ms(r.start_graph.replay), cuda_ms(r.block_graph.replay))
            for key, r in owner._graphs.items() if key in keys]


def loop_pair(label, solver, b, scipy_rel, counters, **solve_kw):
    """Phase 14 on one path: ``graph=False`` (the per-iteration loop), then
    the default (captured blocks). Each: one cold solve (for the captured
    loop it captures, unless an earlier phase did), GRAPH_RUNS warm solves
    (median wall), launches per warm solve, one profiled solve (busy ms,
    its share of the profiled wall and of the warm median); for the
    captured loop, over the runners the warm solves replayed: capture
    seconds, the graph pool's MB, blocks, frozen iterations and inner
    solves per solve, host enqueue µs per block, and the device ms of one
    start and one block replay. Fails unless the counts are equal and both
    certify (≤ 1e-8, scipy ≤ 2e-8). Returns {loop: numbers}."""
    import statistics

    import torch

    def runner_stats(owner):
        return {k: dict(r.stats)
                for k, r in getattr(owner, "_graphs", {}).items()}

    out = {}
    for loop, kw in (("per-iteration", {"graph": False}), ("captured", {})):
        kw = {**solve_kw, **kw}
        owner = solver.hierarchy
        before = runner_stats(owner)
        t0 = time.perf_counter()
        x = solver.solve(b, tol=1e-8, **kw)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        info = dict(solver.last_info)
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
        rel = scipy_rel(x)
        mid = runner_stats(owner)
        reset_counters(counters)
        walls = []
        for _ in range(GRAPH_RUNS):
            t0 = time.perf_counter()
            solver.solve(b, tol=1e-8, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = {k: m.launches // GRAPH_RUNS for k, m in counters.items()
                    if m.launches}
        after = runner_stats(owner)
        used = [k for k in after if after[k]["solves"]
                > mid.get(k, {}).get("solves", 0)]
        wall_p, busy = profile_solve(f"{label} {loop}", solver, b, **kw)
        wall = statistics.median(walls)
        run = dict(info=info, x=x, rel=rel, cold_s=cold, wall_s=wall,
                   walls=walls, launches=launches, busy_ms=busy,
                   busy_share=busy / 1e3 / wall_p,
                   busy_over_warm=busy / 1e3 / wall)
        extra = ""
        if loop == "captured":
            def grown(k):
                return sum(after[u][k] - mid[u][k] for u in used)
            blocks = grown("blocks")
            run.update(
                captured_here=any(u not in before for u in used),
                capture_s=sum(after[u]["capture_s"] for u in used),
                pool_mb=sum(after[u]["pool_bytes"] for u in used) / 2**20,
                path_changed=any(after[u]["path_changed"] for u in used),
                blocks=blocks / GRAPH_RUNS,
                frozen=grown("frozen") / GRAPH_RUNS,
                inner_solves=grown("solves") / GRAPH_RUNS,
                enqueue_us=1e6 * grown("enqueue_s") / max(blocks, 1),
                replay_ms=replay_ms(owner, used))
            replays = [(round(a, 4), round(b, 4))
                       for a, b in run["replay_ms"]]
            extra = (f" capture_s={run['capture_s']:.3f} captured_here="
                     f"{run['captured_here']} pool_MB={run['pool_mb']:.1f} "
                     f"runners={len(used)} blocks_per_solve="
                     f"{run['blocks']:g} frozen_per_solve={run['frozen']:g} "
                     f"inner_solves_per_solve={run['inner_solves']:g} "
                     f"enqueue_us_per_block={run['enqueue_us']:.1f} "
                     f"path_changed={run['path_changed']} replay_ms(start, "
                     f"block)={replays}")
        print(f"graph14 {label} {loop}: inner={info['inner_iters']} "
              f"outer={info['outer_iters']} certified="
              f"{info['rel_residual']:.3e} scipy={rel:.3e} cold_s={cold:.4f}"
              f" warm_s_median={wall:.4f} warm_s="
              f"{[round(w, 4) for w in walls]} busy_ms={busy:.3f} "
              f"busy_share={run['busy_share']:.4f} busy_over_warm_median="
              f"{run['busy_over_warm']:.4f} launches_per_solve={launches}"
              + extra, flush=True)
        out[loop] = run
    e, c = out["per-iteration"], out["captured"]
    dx = float(np.abs(np.asarray(c["x"]) - np.asarray(e["x"])).max())
    same = (e["info"]["inner_iters"], e["info"]["outer_iters"]) == (
        c["info"]["inner_iters"], c["info"]["outer_iters"])
    print(f"graph14 {label} summary: counts equal={same} max_abs_dx="
          f"{dx:.3e} warm_s {e['wall_s']:.4f} -> {c['wall_s']:.4f} "
          f"busy_share {e['busy_share']:.4f} -> {c['busy_share']:.4f} "
          f"busy_over_warm_median {e['busy_over_warm']:.4f} -> "
          f"{c['busy_over_warm']:.4f} capture_s={c['capture_s']:.3f} "
          f"path_changed={c['path_changed']}", flush=True)
    for loop, run in out.items():
        check_certified(f"graph14 {label} {loop}", run["info"], run["rel"])
        if run["rel"] > 2e-8:
            raise AssertionError(f"graph14 {label} {loop}: scipy "
                                 f"{run['rel']:.3e} > 2e-8")
    if not same:
        histories(f"graph14 {label} per-iteration", e["info"])
        histories(f"graph14 {label} captured", c["info"])
        raise AssertionError(f"graph14 {label}: the captured loop's counts "
                             "differ from the per-iteration loop's")
    if not c["replay_ms"]:
        raise AssertionError(f"graph14 {label}: no captured block replayed")
    if dx != 0 and not c["path_changed"]:
        raise AssertionError(f"graph14 {label}: x differs by {dx:.3e} with "
                             "no kernel path changed by the capture")
    return out


def captured_paths(n, counters, mesh_solver):
    """Phase 14: the captured PCG blocks (``solvers/graph.py``) against the
    per-iteration loop on the PMIS n³ path (standard and pipelined), the
    structured n³ path (V and W), the z-slab path on SHARDS shards and the
    PMIS mesh path on SHARDS shards (``mesh_solver``, phase 13c's fresh
    solver of 2.0·A; standard and pipelined); the block size K swept on the
    serial paths (``ksweep`` lines); then a ×2.0 refresh of the PMIS solver
    and a captured solve against a fresh solver's counts, with the old
    hierarchy's graphs dropped."""
    import dataclasses
    import gc
    import weakref

    import torch

    import omp_amg_tpu_torch as amg
    from omp_amg_tpu_torch.solvers import graph as G

    a = amg.poisson3d_7pt(n)
    b = amg.default_rhs(a, seed=SEED)
    b_card = b.to("cuda")
    b64 = b.numpy().astype(np.float64)
    pmis = amg.AMGParams(coarsening="pmis")

    def rel_of(op):
        a_sp = amg.dia_to_scipy(op)
        return lambda x: float(np.linalg.norm(b64 - a_sp @ x)
                               / np.linalg.norm(b64))

    def ksweep(label, solver):
        """The warm wall per block size K (b on the card)."""
        import statistics

        keep = G.BLOCK
        try:
            for k in GRAPH_KSWEEP:
                G.BLOCK = k
                solver.solve(b_card, tol=1e-8, residual="device",
                             device_result=True)
                keys = set(solver.hierarchy._graphs)
                st0 = graph_totals(solver.hierarchy, keys)
                walls = []
                for _ in range(GRAPH_RUNS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    solver.solve(b_card, tol=1e-8, residual="device",
                                 device_result=True)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                st1 = graph_totals(solver.hierarchy, keys)
                key = next(k2 for k2 in solver.hierarchy._graphs
                           if k2[1] == k)
                ((start_ms, block_ms),) = replay_ms(solver.hierarchy, {key})
                print(f"ksweep {label} K={k} warm_s_median="
                      f"{statistics.median(walls):.4f} inner="
                      f"{solver.last_info['inner_iters']} blocks_per_solve="
                      f"{(st1['blocks'] - st0['blocks']) / GRAPH_RUNS:g} "
                      f"frozen_per_solve="
                      f"{(st1['frozen'] - st0['frozen']) / GRAPH_RUNS:g} "
                      f"start_ms={start_ms:.4f} block_ms={block_ms:.4f} "
                      f"block_ms_per_iteration={block_ms / k:.4f}",
                      flush=True)
        finally:
            G.BLOCK = keep

    # the PMIS n³ path, b on the card (device loop, device_result)
    t0 = time.perf_counter()
    solver = amg.AMGSolver(a, pmis, device="cuda", refreshable=True)
    print(f"graph14 pmis n={n}^3 setup_s={time.perf_counter() - t0:.3f} "
          f"block K={G.BLOCK}", flush=True)
    for variant in ("standard", "pipelined"):
        loop_pair(f"pmis n={n}^3 {variant}", solver, b_card, rel_of(a),
                  counters, residual="device", device_result=True,
                  variant=variant)
    ksweep(f"pmis n={n}^3", solver)
    # refresh ×2.0: the old hierarchy's graphs go with it
    old = weakref.ref(next(iter(solver.hierarchy._graphs.values())))
    n_graphs = len(solver.hierarchy._graphs)
    a2 = amg.Dia(data=a.data * 2.0, offsets=a.offsets, dims=a.dims)
    t0 = time.perf_counter()
    solver.refresh(a2)
    refresh_s = time.perf_counter() - t0
    gc.collect()
    if old() is not None:
        raise AssertionError("graph14: a graph outlived its hierarchy")
    x2 = solver.solve(b_card, tol=1e-8, residual="device",
                             device_result=True).cpu().numpy()
    ri = dict(solver.last_info)
    fresh = amg.AMGSolver(a2, pmis, device="cuda")
    fresh.solve(b_card, tol=1e-8, residual="device", device_result=True)
    fi = fresh.last_info
    rel2 = rel_of(a2)(x2)
    print(f"graph14 pmis n={n}^3 refresh x2.0 refresh_s={refresh_s:.3f} "
          f"dropped_graphs={n_graphs} captured inner={ri['inner_iters']} "
          f"outer={ri['outer_iters']} certified={ri['rel_residual']:.3e} "
          f"scipy={rel2:.3e} | fresh inner={fi['inner_iters']} outer="
          f"{fi['outer_iters']} | runners on the new hierarchy="
          f"{len(solver.hierarchy._graphs)}", flush=True)
    check_certified("graph14 refresh x2.0", ri, rel2)
    if (ri["inner_iters"], ri["outer_iters"]) != (fi["inner_iters"],
                                                  fi["outer_iters"]):
        raise AssertionError("graph14 refresh x2.0: counts differ from a "
                             "fresh solver's")
    del solver, fresh

    # the structured n³ path, V and W on one setup, b on the card
    t0 = time.perf_counter()
    solver = amg.AMGSolver(a, amg.AMGParams(), grid=(n,) * 3, device="cuda")
    print(f"graph14 structured n={n}^3 setup_s="
          f"{time.perf_counter() - t0:.3f}", flush=True)
    hier0 = solver.hierarchy
    for cycle in ("v", "w"):
        solver.hierarchy = dataclasses.replace(
            hier0, params=dataclasses.replace(hier0.params, cycle=cycle))
        loop_pair(f"structured n={n}^3 {cycle.upper()}", solver, b_card,
                  rel_of(a), counters, residual="device",
                  device_result=True)
        if cycle == "v":
            ksweep(f"structured n={n}^3", solver)
    del solver, hier0

    # the z-slab path on SHARDS shards (b from the host, as phase 10)
    t0 = time.perf_counter()
    solver = amg.AMGSolver(a, amg.AMGParams(), grid=(n,) * 3,
                           mesh=amg.ShardMesh(SHARDS, "cuda"), device="cuda",
                           transport="remote")
    print(f"graph14 z-slab d={SHARDS} n={n}^3 setup_s="
          f"{time.perf_counter() - t0:.3f}", flush=True)
    loop_pair(f"z-slab d={SHARDS} n={n}^3", solver, b, rel_of(a), counters)
    del solver

    # the PMIS mesh path on SHARDS shards: phase 13c's solver of 2.0·A
    for variant in ("standard", "pipelined"):
        loop_pair(f"pmis mesh d={SHARDS} n={n}^3 x2.0 {variant}",
                  mesh_solver, b, rel_of(a2), counters, variant=variant)


def sparse_api_checks(n, rng):
    """Phase 14: the public sparse API on the card: ``spmv_dia`` and
    ``spmv_csr`` on the PMIS n³ levels 0 and 1 (level 1's A as its global
    CSR where the rule gave it the tiled form; and the constructors'
    default device) against the kernels' twins, each launching its kernel
    once."""
    import torch

    import omp_amg_tpu_torch as amg
    from omp_amg_tpu_torch.ops import csr_spmv, dia_spmv
    from omp_amg_tpu_torch.sparse.formats import tile_to_csr

    a = amg.poisson3d_7pt(n)
    hier = amg.amg_setup(a, amg.AMGParams(coarsening="pmis"), device="cuda")
    small = amg.poisson3d_7pt(16)
    built = {"dia_from_scipy": amg.dia_from_scipy(amg.dia_to_scipy(small)),
             "dia_to_csr": amg.dia_to_csr(small),
             "coo_to_csr": amg.coo_to_csr([0, 0, 1], [0, 0, 1],
                                          [1.0, 2.0, 3.0], (2, 2))}
    for name, op in built.items():
        t = op.data if isinstance(op, amg.Dia) else op.vals
        if not t.is_cuda:
            raise AssertionError(f"sparse API: {name} not on the card")
    if amg.diagonal(built["coo_to_csr"]).cpu().tolist() != [3.0, 3.0]:
        raise AssertionError("sparse API: coo_to_csr did not sum duplicates")
    cases = [("spmv_dia", "L0-A", hier.levels[0].a, dia_spmv,
              lambda op, x: dia_spmv.dia_spmv_plain(op, x), DIA_BOUND),
             ("spmv_csr", "L1-A", tile_to_csr(hier.levels[1].a), csr_spmv,
              lambda op, x: csr_spmv.csr_spmv_plain(op, x), CSR_BOUND),
             ("spmv_dia", "built", built["dia_from_scipy"], dia_spmv,
              lambda op, x: dia_spmv.dia_spmv_plain(op, x), DIA_BOUND),
             ("spmv_csr", "built", built["dia_to_csr"], csr_spmv,
              lambda op, x: csr_spmv.csr_spmv_plain(op, x), CSR_BOUND)]
    for fn, tag, op, mod, plain, bound in cases:
        x = _vec(rng, op.n_rows, "cuda")
        before = mod.launches
        got = getattr(amg, fn)(op, x)
        torch.cuda.synchronize()
        if mod.launches != before + 1:
            raise AssertionError(f"sparse API {fn}: its kernel did not "
                                 "launch once")
        want = plain(op, x)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        print(f"sparse API {fn} {tag} rows={op.n_rows} max_abs_err={err:.3e}"
              f" (bound {bound:g} x {scale:.3e})", flush=True)
        if err > bound * scale:
            raise AssertionError(f"sparse API {fn} {tag}: {err:.3e} from "
                                 "the twin")


def level_tensors(op):
    """The tensors that define a level operator or transfer (a grid
    transfer: none; a ``ConstDia``: its coefficients)."""
    import torch

    import omp_amg_tpu_torch as amg
    from omp_amg_tpu_torch.sparse.formats import TileCsr

    if isinstance(op, amg.ConstDia):
        return [torch.tensor(op.coeffs, dtype=torch.float64)]
    if isinstance(op, amg.Dia):
        return [op.data]
    if isinstance(op, (amg.Csr, TileCsr)):
        return [op.indptr, op.indices, op.vals]
    return []


def same_hierarchy(label, timed, kept):
    """The timed solver's hierarchy against the ``keep_host=True`` copy of
    the same setup: level count, forms, offsets, transfers' shapes equal;
    every operator and transfer tensor, dinv, λmax and the coarse factor
    within 1e-6 relative (the setups are deterministic: the gap printed is
    expected to be 0)."""
    import torch

    if len(timed.levels) != len(kept.levels):
        raise AssertionError(f"{label}: the timed hierarchy has "
                             f"{len(timed.levels)} levels, the kept copy "
                             f"{len(kept.levels)}")
    pairs = [(timed.coarse_chol, kept.coarse_chol)]
    for lt, lk in zip(timed.levels, kept.levels):
        for x, y in ((lt.a, lk.a), (lt.p, lk.p), (lt.r, lk.r)):
            tx, ty = level_tensors(x), level_tensors(y)
            if type(x) is not type(y) or len(tx) != len(ty) \
                    or getattr(x, "offsets", None) != getattr(y, "offsets",
                                                              None) \
                    or getattr(x, "coarse_shape", None) != getattr(
                        y, "coarse_shape", None) \
                    or getattr(x, "coarsened", None) != getattr(
                        y, "coarsened", None):
                raise AssertionError(f"{label}: the timed hierarchy's "
                                     f"{type(x).__name__} differs in form "
                                     "from the kept copy's")
            pairs += list(zip(tx, ty))
        pairs.append((torch.as_tensor(lt.dinv), torch.as_tensor(lk.dinv)))
        pairs.append((torch.tensor(lt.lmax, dtype=torch.float64),
                      torch.tensor(lk.lmax, dtype=torch.float64)))
    gap, bitwise = 0.0, True
    for x, y in pairs:
        x, y = x.detach().cpu(), y.detach().cpu()
        if x.shape != y.shape:
            raise AssertionError(f"{label}: the timed hierarchy's shapes "
                                 "differ from the kept copy's")
        bitwise &= torch.equal(x, y)
        x, y = x.double(), y.double()
        scale = float(y.abs().max()) if y.numel() else 0.0
        if y.numel():
            gap = max(gap, float((x - y).abs().max()) / max(scale, 1e-300))
    print(f"{label}: timed solver's hierarchy vs the keep_host copy: "
          f"{len(pairs)} tensors, bitwise={bitwise}, max rel gap "
          f"{gap:.2e}", flush=True)
    if gap > 1e-6:
        raise AssertionError(f"{label}: the timed hierarchy differs from the "
                             f"kept copy by {gap:.2e} relative")


def flavor_pair(label, a, params, grid, counters):
    """Phase 15a/15b: the same setup in both flavors through ``AMGSolver``
    (each a main path: counters set to 0 before the setup, read after it
    and after the certified solve), each traced (``OMP_AMG_SETUP_TIMERS``);
    then each once more with ``keep_host=True`` for the C/F states and host
    operators (not counted), checked against the timed solver's own
    hierarchy (:func:`same_hierarchy`), so that what is compared is what
    was timed. Returns ({flavor: launches}, {flavor: run}, {flavor: (hier,
    HostSetup)})."""
    import os

    import omp_amg_tpu_torch as amg

    launches, runs, kept = {}, {}, {}
    for flavor in ("device", "host"):
        os.environ["OMP_AMG_SETUP_TIMERS"] = "1"
        try:
            solver, launches[flavor], runs[flavor] = drive(
                f"{label} flavor={flavor}", a, params, grid, counters,
                flavor=flavor)
        finally:
            del os.environ["OMP_AMG_SETUP_TIMERS"]
        runs[flavor]["trace"] = amg.last_setup_trace()
        phases = " ".join(f"{k}={v:.3f}" for k, v in runs[flavor]["trace"])
        used = {k: v for k, v in runs[flavor]["setup_launches"].items() if v}
        print(f"{label} flavor={flavor} setup_s="
              f"{runs[flavor]['setup_s']:.3f} setup launches={used} "
              f"trace: {phases}", flush=True)
        kept[flavor] = amg.amg_setup(a, params, grid=grid, device="cuda",
                                     flavor=flavor, keep_host=True)
        same_hierarchy(f"{label} flavor={flavor}", solver.hierarchy,
                       kept[flavor][0])
        del solver
    d, h = runs["device"]["info"], runs["host"]["info"]
    print(f"{label}: setup_s device {runs['device']['setup_s']:.3f} vs host "
          f"{runs['host']['setup_s']:.3f}; inner {d['inner_iters']} vs "
          f"{h['inner_iters']}; outer {d['outer_iters']} vs "
          f"{h['outer_iters']}; certified {d['rel_residual']:.3e} vs "
          f"{h['rel_residual']:.3e}", flush=True)
    if (d["inner_iters"], d["outer_iters"]) != (h["inner_iters"],
                                                h["outer_iters"]):
        for tag, info in (("device", d), ("host", h)):
            for k, hist in enumerate(info["residual_histories"]):
                print(f"history {label} {tag} outer={k}: "
                      + " ".join(f"{x:.6e}" for x in hist), flush=True)
        if abs(sum(d["inner_iters"]) - sum(h["inner_iters"])) > 1:
            raise AssertionError(f"{label}: the flavors' counts differ by "
                                 "more than one")
    return launches, runs, kept


def rel_gap(x, y) -> float:
    """max |x − y| / max |y| of two scipy matrices."""
    return float(abs(x - y).max() / max(abs(y).max(), 1e-300))


def device_setups(n, counters, s3_setup_s):
    """Phase 15: the device-flavor setups against the host flavor, the
    device RAP engines, the CLI's device-only build and GPU/CPU parity.
    Returns {path: launches} of its main paths."""
    import contextlib
    import io

    import torch

    import omp_amg_tpu_torch as amg
    from omp_amg_tpu_torch import cli
    from omp_amg_tpu_torch.amg import comb_rap
    from omp_amg_tpu_torch.problems import poisson

    t_phase = time.perf_counter()
    a = amg.poisson3d_7pt(n)
    paths = {}

    # 15a: PMIS, direct interpolation (the device flavor's only one)
    direct = amg.AMGParams(coarsening="pmis", interp="direct")
    launches, runs, kept = flavor_pair(f"pmis-direct n={n}^3", a, direct,
                                       None, counters)
    paths["pmis_direct_device"] = launches["device"]
    paths["pmis_direct_host"] = launches["host"]
    expect_launches("pmis-direct device", launches["device"],
                    ("dia_spmv", "csr_spmv", "pcg_update", "ir_f64"),
                    hier=kept["device"][0])
    setup_used = runs["device"]["setup_launches"]
    if not (setup_used["dia_spmv"] > 0 and setup_used["csr_spmv"] > 0):
        raise AssertionError("pmis device setup: λmax did not run dia_spmv "
                             f"and csr_spmv ({setup_used})")
    (hd, sd), (hh, sh) = kept["device"], kept["host"]
    if len(hd.levels) != len(hh.levels):
        raise AssertionError("pmis: the flavors' level counts differ")
    states_equal = all(np.array_equal(x, y)
                       for x, y in zip(sd.states, sh.states))
    gaps = [rel_gap(x, y) for x, y in zip(sd.ops, sh.ops)]
    dinv_gap = max(float(np.max(np.abs(ld.dinv.cpu().numpy() - lh.dinv)
                                / np.abs(lh.dinv)))
                   for ld, lh in zip(hd.levels, hh.levels))
    lmax = [(ld.lmax, lh.lmax) for ld, lh in zip(hd.levels, hh.levels)]
    lmax_gap = max(abs(x - y) / y for x, y in lmax)
    print(f"pmis-direct flavors: levels={len(hd.levels)} states bitwise="
          f"{states_equal} A_l rel gaps={[f'{g:.2e}' for g in gaps]} "
          f"dinv rel gap={dinv_gap:.2e} lmax device/host="
          f"{[(round(x, 6), round(y, 6)) for x, y in lmax]} "
          f"(rel gap {lmax_gap:.2e})", flush=True)
    if not states_equal or max(gaps) > 1e-5 or dinv_gap > 1e-5 \
            or lmax_gap > 1e-3:
        raise AssertionError("pmis: the device flavor's hierarchy differs "
                             "from the host flavor's")
    del hd, sd, hh, sh, kept, runs

    # 15b: structured 7-point n³
    launches, runs, kept = flavor_pair(f"structured n={n}^3", a,
                                       amg.AMGParams(), (n,) * 3, counters)
    paths["structured_device"] = launches["device"]
    paths["structured_host"] = launches["host"]
    expect_launches("structured device", launches["device"],
                    ("const_stencil", "dia_spmv", "grid_transfer",
                     "pcg_update", "ir_f64"))
    if runs["device"]["setup_launches"]["dia_spmv"] == 0:
        raise AssertionError("structured device setup: λmax did not run "
                             "dia_spmv")
    print(f"structured n={n}^3 host flavor setup_s in phase 7 (no trace): "
          f"{s3_setup_s:.3f}", flush=True)
    (hd, sd), (hh, sh) = kept["device"], kept["host"]
    shapes = [(lv.p.coarse_shape, lv.p.coarsened) for lv in hd.levels]
    if shapes != [(lv.p.coarse_shape, lv.p.coarsened) for lv in hh.levels]:
        raise AssertionError("structured: the flavors' coarse shapes or "
                             "axes differ")
    if not isinstance(hd.levels[0].a, amg.ConstDia):
        raise AssertionError("structured device: L0 is not a ConstDia")
    gaps = [rel_gap(x, y) for x, y in zip(sd.ops[1:], sh.ops[1:])]
    lmax = [(ld.lmax, lh.lmax) for ld, lh in zip(hd.levels, hh.levels)]
    lmax_gap = max(abs(x - y) / y for x, y in lmax)
    # comb_rap_device's "auto" is the factored engine on every level; it
    # raises ValueError outside its radius-1 contract, and the setup ran
    engines = ["factored"] * len(hd.levels)
    print(f"structured flavors: shapes={shapes} forms="
          f"{[type(lv.a).__name__ for lv in hd.levels]} engines={engines} "
          f"planes rel gaps={[f'{g:.2e}' for g in gaps]} lmax device/host="
          f"{[(round(x, 6), round(y, 6)) for x, y in lmax]} (rel gap "
          f"{lmax_gap:.2e})", flush=True)
    if max(gaps) > 1e-5 or lmax_gap > 1e-2:
        raise AssertionError("structured: the device flavor's planes or "
                             "λmax differ from the host flavor's")
    del hd, sd, hh, sh, kept, runs

    # the device RAP at L0: factored against comb, and against TF32
    dims = (n,) * 3
    cdims = tuple((d + 1) // 2 for d in dims)
    axes = (True,) * 3
    data = torch.from_numpy(a.data.astype(np.float32)).to("cuda")
    rap = {}
    for engine in ("factored", "comb", "factored"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        offs, planes = comb_rap.comb_rap_device(a.offsets, data, dims, cdims,
                                                axes, engine=engine)
        torch.cuda.synchronize()
        rap[engine] = (offs, planes, time.perf_counter() - t0)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        offs_t, planes_t = comb_rap.comb_rap_device(
            a.offsets, data, dims, cdims, axes, engine="factored")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    (of, pf, tf), (oc, pc, tc) = rap["factored"], rap["comb"]
    scale = float(pf.abs().max())
    fc = float((pf - pc).abs().max()) / scale
    tf32 = float((planes_t - pf).abs().max()) / scale
    print(f"device RAP L0 n={n}^3: factored {tf:.4f} s (warm), comb "
          f"{tc:.4f} s, {len(of)} taps; factored vs comb rel {fc:.2e}; "
          f"with allow_tf32=True rel {tf32:.2e} (restored to {prev})",
          flush=True)
    if of != oc or of != offs_t or fc > 1e-5 or tf32 > 1e-6:
        raise AssertionError("device RAP: the engines disagree, or the "
                             "factored engine depends on TF32")
    del data, rap, planes_t

    # 15c: aniso9pt 256² (f32 values, as phase 9), structured device
    gen, gargs, grid, record = STRUCTURED_PARITY["aniso9pt_256_eps1e-3"]
    op = getattr(amg, gen)(*gargs)
    op = amg.Dia(data=op.data.astype(np.float32).astype(np.float64),
                 offsets=op.offsets, dims=op.dims)
    solver, paths["aniso_device"], run = drive(
        "aniso9pt_256_eps1e-3 flavor=device", op, amg.AMGParams(), grid,
        counters, flavor="device")
    expect_launches("aniso device", paths["aniso_device"],
                    ("dia_spmv", "grid_transfer", "pcg_update", "ir_f64"))
    axes0 = solver.hierarchy.levels[0].p.coarsened
    info = run["info"]
    print(f"aniso9pt_256_eps1e-3 device: L0 axes={axes0} inner="
          f"{sum(info['inner_iters'])} outer={info['outer_iters']} | TPU "
          f"record (bench_details.json) {record[0]} in {record[1]} outer",
          flush=True)
    if axes0 != (True, False):
        raise AssertionError(f"aniso device: L0 coarsened {axes0}")
    del solver, op

    # 15d: the CLI's device-only build, in process
    built = []
    host_planes = poisson._host_planes

    def recording(dims_, items):
        built.append(dims_)
        return host_planes(dims_, items)
    poisson._host_planes = recording
    reset_counters(counters)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--problem", "3d7pt", "--n", str(DEVICE_CLI_N),
                           "--setup-flavor", "device", "--json"])
    finally:
        poisson._host_planes = host_planes
    torch.cuda.synchronize()
    paths["cli_device_only"] = {name: mod.launches
                                for name, mod in counters.items()}
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"cli device-only 3d7pt n={DEVICE_CLI_N}: rc={rc} "
          f"host planes built={built} timers_s="
          f"{json.dumps(summary['timers_s'])} iters={summary['iters']} "
          f"true_rel_residual={summary['true_rel_residual']:.3e} "
          f"levels={summary['levels']} launches="
          f"{ {k: v for k, v in paths['cli_device_only'].items() if v} } | "
          f"TPU record (BASELINE.md) {TPU_RECORD_CLI_256[0]} inner + "
          f"{TPU_RECORD_CLI_256[1]} outer", flush=True)
    if rc != 0 or summary["true_rel_residual"] > 1e-8 \
            or summary["backend"] != "cuda":
        raise AssertionError("cli device-only: not certified on the card")
    if any(max(d) > 4 for d in built):
        raise AssertionError(f"cli device-only: host planes built {built}")
    expect_launches("cli device-only", paths["cli_device_only"],
                    ("const_stencil", "dia_spmv", "grid_transfer",
                     "pcg_update", "ir_f64"))

    # 15e: GPU/CPU parity of both device flavors
    m = DEVICE_PARITY_N
    parity(f"pmis-direct device n={m}^3", amg.poisson3d_7pt(m), direct,
           None, flavor="device")
    parity(f"structured device n={m}^3", amg.poisson3d_7pt(m),
           amg.AMGParams(), (m,) * 3, flavor="device")
    print(f"phase 15 seconds={time.perf_counter() - t_phase:.1f}",
          flush=True)
    return paths


# --- phase 16: the mesh that spans processes, and the scaling model ---------

PROC_RANKS = 2          # phase 16: ranks on the one card
PROC_LOCAL = 2          # shards per rank (2 × 2 = phases 10 and 13's 4)
PROC_RUNS = 5           # warm solves per rank (median reported)
PROC_TIMEOUT = 420      # seconds, per rank


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(args) -> int:
    """One rank of phase 16 (``--phase16-rank pmis|slab``), on the card:
    ``maybe_initialize`` from the env gate, ``global_mesh(PROC_LOCAL)``,
    the main path through ``AMGSolver`` with every counter set to 0 just
    before it and read just after; x (rank 0) into ``--out``; one
    ``RESULT`` JSON line."""
    import torch

    import omp_amg_tpu_torch as amg
    from omp_amg_tpu_torch.ops import remote_halo
    from omp_amg_tpu_torch.parallel.multihost import (
        global_mesh, maybe_initialize,
    )

    global PEAK
    PEAK = card_peak(torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not maybe_initialize():
        raise RuntimeError("phase 16 rank without the OMP_AMG_* env gate")
    mesh = global_mesh(PROC_LOCAL)
    counters = kernel_counters()
    n = args.n
    a = amg.poisson3d_7pt(n)
    b = amg.default_rhs(a, seed=SEED)
    runs = {}
    if args.phase16_rank == "pmis":
        cases = (("remote", amg.AMGParams(coarsening="pmis"), None),)
    else:
        cases = tuple((t, amg.AMGParams(), (n,) * 3)
                      for t in ("remote", "ppermute"))
    for transport, params, grid in cases:
        reset_counters(counters)
        remote_halo.ipc_launches = 0
        mesh.reset_stats()
        t0 = time.perf_counter()
        solver = amg.AMGSolver(a, params, grid=grid, mesh=mesh,
                               device="cuda", transport=transport)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        x = solver.solve(b, tol=1e-8)
        torch.cuda.synchronize()
        launches = {k: m.launches for k, m in counters.items()}
        ipc = remote_halo.ipc_launches
        info = solver.last_info
        iters = sum(info["inner_iters"])
        walls, stats = [], []
        for _ in range(PROC_RUNS):
            mesh.reset_stats()
            t0 = time.perf_counter()
            solver.solve(b, tol=1e-8)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            stats.append(dict(mesh.stats))
            if (solver.last_info["inner_iters"], solver.last_info[
                    "outer_iters"]) != (info["inner_iters"],
                                        info["outer_iters"]):
                raise AssertionError("a warm solve's counts changed")
        from omp_amg_tpu_torch.solvers.graph import graph_stats

        g = list(graph_stats(solver.hierarchy).values())
        if mesh.rank == 0:
            np.save(f"{args.out}/x_{args.phase16_rank}_{transport}.npy", x)
        k = int(np.argsort(walls)[len(walls) // 2])
        runs[transport] = dict(
            setup_s=setup_s, inner=info["inner_iters"],
            outer=info["outer_iters"], rel=info["rel_residual"],
            launches=launches, ipc_launches=ipc,
            scalar=remote_halo.scalar_launches,
            warm_s=sorted(walls), iters=iters,
            sizes=solver.stats()["sizes"],
            sharded=solver.stats()["sharded"],
            stats=stats[k], graph=g,
            forms=[type(lv.a).__name__ for lv in solver.hierarchy.levels])
        if transport == "remote" and args.phase16_rank == "slab":
            runs["window"] = ipc_window_row(solver.hierarchy, mesh)
        del solver
    mesh.close()
    print("RESULT " + json.dumps(dict(rank=mesh.rank, world=mesh.world,
                                      device=str(mesh.device), runs=runs)),
          flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def ipc_window_row(dh, mesh):
    """The cross-process ``remote_halo`` window on the level-0 shards of
    the z-slab hierarchy ``dh`` (random x from the seed): exact against the
    twin on the gathered shards; the kernel alone (CUDA events, cold L2)
    against its twin with the same strips, and the whole exchange (strip
    copies, stream sync, barrier, launch) on the host clock."""
    import torch

    from omp_amg_tpu_torch.ops import remote_halo as rh

    a0 = dh.levels[0].a
    n_loc = a0.n_rows // a0.nshards
    nl, nr = a0.hl * a0.plane, a0.hr * a0.plane
    rng = np.random.default_rng(SEED)
    full = torch.from_numpy(rng.standard_normal(a0.n_rows)
                            .astype(np.float32)).cuda()
    xs = mesh.shard(full)
    got = mesh.remote_windows(xs, nl, nr)
    shards = list(full.view(mesh.size, n_loc))
    want = rh.remote_halo_window_plain(shards, nl, nr)[
        mesh.first:mesh.first + mesh.local]
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if err != HALO_BOUND:
        raise AssertionError(f"cross-process remote_halo: max|Δ| {err} "
                             "against the twin on the gathered shards")
    box = mesh._mail
    lo, hi = box.outer(box.exchanges - 1, nl, nr)   # the last exchange's
    lo_t = shards[mesh.first - 1][n_loc - nl:] if mesh.first else None
    hi_t = (shards[mesh.first + mesh.local][:nr]
            if mesh.first + mesh.local < mesh.size else None)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    vec = rh.vector_path(xs, n_loc, nl, nr, (lo, hi))
    nbytes = 4 * mesh.local * (nl + n_loc + nr) + 4 * (
        mesh.local * n_loc + (mesh.local - 1) * (nl + nr)
        + (nl if lo else 0) + (nr if hi else 0))
    row = compare(f"remote_halo:ipc:L0:rank={mesh.rank}:local={mesh.local}"
                  f":n_loc={n_loc}:nl={nl}:nr={nr}:path="
                  f"{'vector' if vec else 'scalar'}",
                  lambda: rh.remote_halo_window(xs, nl, nr, outer=(lo, hi)),
                  lambda: rh.remote_halo_window_plain(xs, nl, nr, lo_t,
                                                      hi_t),
                  HALO_BOUND, nbytes, flush, flat=lambda w: w.reshape(-1))
    del flush
    calls = 50
    for transport, fn in (
            ("remote", lambda: mesh.remote_windows(xs, nl, nr)),
            ("ppermute", lambda: mesh.strips(xs, nl, nr))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        row[f"exchange_{transport}_us"] = (time.perf_counter() - t0) \
            / calls * 1e6
    row["gathered_err"] = err
    return row


def _launch_ranks(kind, n, out_dir):
    """Start ``PROC_RANKS`` ranks of this script (``--phase16-rank kind``)
    on the card and wait for them; a rank that fails, or outlasts
    ``PROC_TIMEOUT``, raises. Returns each rank's RESULT."""
    port = _free_port()
    procs = []
    try:
        for r in range(PROC_RANKS):
            env = dict(os.environ, OMP_AMG_COORDINATOR=f"127.0.0.1:{port}",
                       OMP_AMG_NUM_PROCS=str(PROC_RANKS),
                       OMP_AMG_PROC_ID=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--n", str(n),
                 "--phase16-rank", kind, "--out", out_dir], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=PROC_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"phase 16 {kind} rank {r} exited "
                               f"{p.returncode}:\n{out[-3000:]}\n"
                               f"{err[-6000:]}")
        for line in out.splitlines():
            if line.startswith("check "):
                print(line, flush=True)
        results.append(json.loads(next(
            ln for ln in out.splitlines() if ln.startswith("RESULT "))[7:]))
    return results


def process_mesh_paths(n, pm_run, sh_run):
    """Phase 16a-b (module docstring). Returns ({path: launches summed over
    the ranks}, the cross-process window rows)."""
    import tempfile

    import omp_amg_tpu_torch as amg

    a = amg.poisson3d_7pt(n)
    b64 = amg.default_rhs(a, seed=SEED).numpy().astype(np.float64)
    a_sp = amg.dia_to_scipy(a)
    paths, windows = {}, []
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="phase16-", dir=here) as out:
        for kind, ref_run, transports in (
                ("pmis", pm_run, ("remote",)),
                ("slab", sh_run, ("remote", "ppermute"))):
            t0 = time.perf_counter()
            res = _launch_ranks(kind, n, out)
            wall = time.perf_counter() - t0
            want = (ref_run["info"]["inner_iters"],
                    ref_run["info"]["outer_iters"])
            xs = {}
            for t in transports:
                runs = [r["runs"][t] for r in res]
                x = np.load(f"{out}/x_{kind}_{t}.npy")
                xs[t] = x
                rel = float(np.linalg.norm(b64 - a_sp @ x)
                            / np.linalg.norm(b64))
                dx = float(np.abs(x - ref_run["x"]).max())
                launches = {k: sum(r["launches"][k] for r in runs)
                            for k in runs[0]["launches"]}
                ipc = sum(r["ipc_launches"] for r in runs)
                label = (f"process{'16a' if kind == 'pmis' else '16b'} "
                         f"{kind} ranks={PROC_RANKS}x{PROC_LOCAL} {t} "
                         f"n={n}^3")
                st, r0 = runs[0]["stats"], runs[0]
                med = [r["warm_s"][len(r["warm_s"]) // 2] for r in runs]
                print(f"{label} devices={[r['device'] for r in res]} "
                      f"sizes={r0['sizes']} sharded={r0['sharded']} "
                      f"forms={r0['forms']} setup_s="
                      f"{[round(r['setup_s'], 3) for r in runs]} inner="
                      f"{r0['inner']} outer={r0['outer']} certified="
                      f"{r0['rel']:.3e} scipy={rel:.3e} max|dx| vs one "
                      f"process={dx:.3g} warm_solve_s(median of "
                      f"{PROC_RUNS})={[round(m, 4) for m in med]} "
                      f"warm_all={[r['warm_s'] for r in runs]} launches="
                      f"{launches} ipc_launches={ipc} mesh_stats(rank 0, "
                      f"median solve): calls={st['calls']} bytes="
                      f"{st['bytes']} transfer_s={st['seconds']:.4f} "
                      f"calls_per_iter={st['calls'] / r0['iters']:.1f} "
                      f"bytes_per_iter={st['bytes'] / r0['iters']:.0f} "
                      f"transfer_share={st['seconds'] / med[0]:.3f} "
                      f"graph={r0['graph']} wall_s={wall:.1f}", flush=True)
                for r in runs:
                    if (r["inner"], r["outer"]) != want:
                        raise AssertionError(
                            f"{label}: counts {r['inner']}/{r['outer']} "
                            f"differ from the one-process mesh's {want}")
                    if r["graph"][0]["captured"] is not False:
                        raise AssertionError(f"{label}: graph_stats does "
                                             "not report the eager loop")
                check_certified(label, dict(rel_residual=r0["rel"]), rel)
                used = ({"csr_spmv", "remote_halo", "pcg_update"}
                        if kind == "pmis" else
                        {"dia_spmv", "remote_halo", "grid_transfer",
                         "pcg_update", "ir_f64"})
                if t == "ppermute":
                    used -= {"remote_halo"}
                expect_launches(label, launches, used)
                if t == "remote" and ipc != launches["remote_halo"]:
                    raise AssertionError(f"{label}: {launches['remote_halo']}"
                                         f" remote_halo launches, {ipc} of "
                                         "them cross-process")
                if kind == "pmis" and dx != 0.0:
                    raise AssertionError(f"{label}: x differs from the "
                                         "one-process ShardMesh's")
                paths[f"process_{kind}_{t}"] = launches
            if kind == "slab":
                if not np.array_equal(xs["remote"], xs["ppermute"]):
                    raise AssertionError("process16b: remote differs from "
                                         "ppermute")
                dx10 = float(np.abs(xs["remote"] - ref_run["x"]).max())
                print(f"process16b remote == ppermute: x bitwise equal; "
                      f"max|dx| vs phase 10 {dx10:.3g}", flush=True)
                if dx10 != 0.0:
                    raise AssertionError("process16b: x differs from phase "
                                         "10's one-process mesh")
                for r in res:
                    row = r["runs"]["window"]
                    windows.append(row)
                    print(f"process16b window rank={r['rank']} kernel_us="
                          f"{row['ms'] * 1e3:.2f} plain_us="
                          f"{row['plain_ms'] * 1e3:.2f} bound_us="
                          f"{row['bound_us']:.2f} exchange_us (strip copies,"
                          f" sync, barrier, launch)="
                          f"{row['exchange_remote_us']:.1f} ppermute strips"
                          f" exchange_us={row['exchange_ppermute_us']:.1f} "
                          f"max_abs_err={row['max_abs_err']} gathered_err="
                          f"{row['gathered_err']}", flush=True)
    return paths, windows


def scaling_constants(n, flush):
    """Phase 16c: the scaling model's machine constants on this card, and
    its reports for PMIS and structured n³ calibrated to each one's
    measured V-cycle. Returns the constants."""
    import torch

    import omp_amg_tpu_torch as amg
    from omp_amg_tpu_torch.ops import csr_spmv
    from omp_amg_tpu_torch.parallel.scaling_model import (
        MachineModel, scaling_report,
    )

    src = torch.empty(1 << 28, dtype=torch.float32, device="cuda")  # 1 GiB
    dst = torch.empty_like(src)
    copy_ms = cuda_ms(lambda: dst.copy_(src), reps=10)
    hbm_gbps = 2 * src.numel() * 4 / copy_ms / 1e6
    del src, dst
    small = amg.dia_to_csr(amg.dia_from_scipy(amg.dia_to_scipy(
        amg.poisson2d_5pt(32)), device="cuda"))
    xs = torch.ones(small.n_rows, device="cuda")
    stage_us = cuda_ms(lambda: csr_spmv.spmv(small, xs), flush=flush) * 1e3
    machine = MachineModel(hbm_gbps=hbm_gbps, stage_latency_us=stage_us)
    print(f"scaling16c constants hbm_gbps={hbm_gbps:.1f} (1 GiB copy "
          f"{copy_ms:.4f} ms) stage_latency_us={stage_us:.3f} (csr_spmv "
          f"{small.n_rows} rows) defaults={MachineModel()}", flush=True)
    a = amg.poisson3d_7pt(n)
    r = amg.default_rhs(a, seed=SEED).to("cuda")
    for label, params, grid in (
            ("pmis", amg.AMGParams(coarsening="pmis"), None),
            ("structured", amg.AMGParams(), (n,) * 3)):
        hier = amg.amg_setup(a, params, device="cuda", grid=grid)
        vms = cuda_ms(lambda: amg.vcycle(hier, r))
        rep = scaling_report(hier, grid=grid, machine=machine,
                             measured_t_cycle_ms=vms)
        pred = {k: {f: v[f] for f in ("t_cycle_ms", "weak_efficiency",
                                      "weak_efficiency_lo",
                                      "weak_efficiency_hi")}
                for k, v in rep["predicted"].items()}
        print(f"scaling16c {label} n={n}^3 family={rep['family']} "
              f"vcycle_ms={vms:.4f} levels={len(rep['levels'])} predicted="
              f"{json.dumps(pred)}", flush=True)
        del hier
    return machine


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=128,
                    help="grid edge of the 3D 7-point Poisson main paths")
    ap.add_argument("--phase16-rank", choices=("pmis", "slab"),
                    help="run as one rank of phase 16 (started by phase 16 "
                         "itself, with the OMP_AMG_* env gate)")
    ap.add_argument("--out", help="phase 16 rank: where rank 0 writes x")
    args = ap.parse_args()

    import torch

    # phase 1: the card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 1
    if args.phase16_rank:
        return rank_main(args)
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
    from omp_amg_tpu_torch.sparse.formats import bf16_lossless

    counters = kernel_counters()

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

    # phase 3c: the tiled CSR kernel on the long-row operators of the
    # pmis7_256 and pmis27_128_cheby cells' hierarchies
    rows["tile_csr"] = (
        tile_csr_checks(f"7pt{TILE_N}", amg.poisson3d_7pt(TILE_N), pmis,
                        flush)
        + tile_csr_checks(f"27pt{CHEBY_N}", amg.poisson3d_27pt(CHEBY_N),
                          amg.AMGParams(coarsening="pmis",
                                        smoother="chebyshev", rap="probe"),
                          flush))

    # phase 4: the PMIS main path, the launches of one V-cycle, and a
    # profile of one warm solve
    solver, pmis_launches, host_run = drive(f"pmis n={args.n}^3", a, pmis,
                                            None, counters)
    expect_launches("pmis", pmis_launches,
                    ("dia_spmv", "csr_spmv", "pcg_update", "ir_f64"),
                    hier=solver.hierarchy)
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
                    ("dia_spmv", "csr_spmv", "panel_spmm", "extract_lanes",
                     "pcg_update", "ir_f64"), hier=solver.hierarchy)
    same_probe_values("pmis probe", solver, host)
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

    # phase 6a: grid_transfer kernel checks
    rows["grid_transfer"] = grid_transfer_checks(rng, flush)

    # phase 6b: pcg_update kernel checks; 6c: captured solves against the
    # where-form step on the cells' 256³ paths
    rows["pcg_update"] = pcg_update_checks(rng, flush)
    pcg_where_form_checks(counters)

    # phase 6d: ir_f64 kernel checks; 6e: a certified 256³ solve against
    # the twins (the loop's torch forms)
    rows["ir_f64"] = ir_f64_checks(rng, flush)
    certified_twin_checks(counters)

    def banded_checks(tag, lv):
        dts = [torch.float32]
        if bf16_lossless(lv.a.data.float().cpu().numpy()):
            dts.append(torch.bfloat16)
        rows["dia_spmv"] += dia_checks(tag, lv.a, lv.s, rng, flush, dts)

    # phase 7: the 3D structured main path, then dia_spmv on its levels
    solver, s3_launches, s3_run = drive(f"structured n={args.n}^3", a,
                                   amg.AMGParams(), (args.n,) * 3, counters)
    expect_launches("structured 3D", s3_launches,
                    ("const_stencil", "dia_spmv", "grid_transfer",
                     "pcg_update", "ir_f64"))
    for l, lv in enumerate(solver.hierarchy.levels[1:], 1):
        banded_checks(f"S3-L{l}-A", lv)
    del solver

    # phase 8: the 2D structured path, then dia_spmv on its 1024² and 512²
    # operators
    a2 = amg.poisson2d_5pt(N2D)
    solver, s2_launches, s2_run = drive(f"structured 2D n={N2D}^2", a2,
                                   amg.AMGParams(), (N2D, N2D), counters)
    expect_launches("structured 2D", s2_launches,
                    ("dia_spmv", "grid_transfer", "pcg_update", "ir_f64"))
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

    # phase 12: the value-only refresh and the CLI
    refresh_launches = refresh_paths(counters)
    cli_launches = cli_paths(counters)

    # phase 13: the row-sharded PMIS path on one card
    pm_launches, pm_run, pm_rows, pm_solver = pmis_mesh_path(
        args.n, counters, flush, rng)
    for name, more in pm_rows.items():
        rows[name] += more

    # phase 14: the captured PCG blocks against the per-iteration loop, and
    # the public sparse API's products on the card
    t0 = time.perf_counter()
    captured_paths(args.n, counters, pm_solver)
    del pm_solver
    sparse_api_checks(args.n, rng)
    print(f"phase 14 seconds={time.perf_counter() - t0:.1f}", flush=True)

    # phase 15: the device-flavor setups, the device RAP engines and the
    # CLI's device-only build
    device_launches = device_setups(args.n, counters, s3_run["setup_s"])

    # phase 16: the mesh that spans processes (two ranks on the card: the
    # PMIS path, the z-slab path on both transports, the cross-process
    # remote_halo), then the scaling model's constants and reports
    t0 = time.perf_counter()
    proc_launches, ipc_rows = process_mesh_paths(args.n, pm_run, sh_run)
    rows["remote_halo"] += ipc_rows
    scaling_constants(args.n, flush)
    print(f"phase 16 seconds={time.perf_counter() - t0:.1f}", flush=True)

    if any(m.startswith(("jax", "omp_amg_tpu.")) or m == "omp_amg_tpu"
           for m in sys.modules):
        raise AssertionError("the JAX package was imported")

    paths = {"pmis": pmis_launches, "pmis_probe": probe_launches,
             "structured_3d": s3_launches, "structured_2d": s2_launches,
             "sharded_3d": sh_launches, **cheby_paths, **option_launches,
             **sharded_launches, **refresh_launches, **cli_launches,
             **pm_launches, **device_launches, **proc_launches}
    launches = {name: sum(p[name] for p in paths.values())
                for name in counters}
    print("main-path launches: " + " ".join(f"{k}={v}"
                                            for k, v in paths.items()),
          flush=True)
    runs = {"pmis": host_run, "pmis_probe": probe_run,
            "structured_3d": s3_run, "structured_2d": s2_run,
            "sharded_3d": sh_run, "pmis_mesh": pm_run}
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
          f"panel_spmm:L0-A·PV, extract_lanes:L0, "
          f"remote_halo:L0:d={SHARDS} (the windows; cross_process: the "
          f"window of phase 16b's L0 on each rank, through CUDA IPC) and "
          f"grid_transfer:{TRANSFER_N}^3:restrict:f32 (modes: all three "
          f"f32 rows) and pcg_update:{PCG_N}^3:xr:f32 (modes: xr and p, "
          f"f32 and f64) and ir_f64:{IR_N}^3 residual (modes: residual, "
          f"defect and update, 7-point {IR_N}^3 and 27-point {IR27_N}^3) "
          f"and tile_csr:7pt{TILE_N}:L1-A:bf16:jacobi (modes: every "
          f"operator of phase 3c) "
          f"with a cold L2; "
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
        dict(summary("remote_halo", "omp_amg_tpu_torch/csrc/remote_halo.cu",
                     "omp_amg_tpu/parallel/slab.py:138, "
                     "omp_amg_tpu/parallel/slab.py:172",
                     f"remote_halo:L0:d={SHARDS}:"),
             cross_process=[{k: r[k] for k in (
                 "name", "max_abs_err", "gathered_err", "ms", "plain_ms",
                 "bound_ms", "exchange_remote_us", "exchange_ppermute_us")}
                 for r in ipc_rows]),
        dict(summary("grid_transfer", "omp_amg_tpu_torch/csrc/grid_transfer.cu",
                     "none (the reference's transfers are not Pallas)",
                     f"grid_transfer:{TRANSFER_N}^3:restrict:f32"),
             modes=[{k: r[k] for k in ("name", "ms", "plain_ms", "bound_us")}
                    for r in rows["grid_transfer"]
                    if r["name"].endswith(":f32")]),
        dict(summary("pcg_update", "omp_amg_tpu_torch/csrc/pcg_update.cu",
                     "none (the reference's PCG updates are not Pallas)",
                     f"pcg_update:{PCG_N}^3:xr:f32"),
             modes=[{k: r[k] for k in ("name", "ms", "plain_ms", "bound_us")}
                    for r in rows["pcg_update"]]),
        dict(summary("ir_f64", "omp_amg_tpu_torch/csrc/dia_spmv.cu (f64), "
                     "omp_amg_tpu_torch/csrc/ir_f64.cu",
                     "none (the reference's certified loop is not Pallas)",
                     f"ir_f64:7pt{IR_N}^3:residual"),
             modes=[{k: r[k] for k in ("name", "ms", "plain_ms", "bound_us",
                                       "library_ms")}
                    for r in rows["ir_f64"]]),
        dict(summary("tile_csr", "omp_amg_tpu_torch/csrc/tile_csr.cu",
                     "none (a second form of "
                     "omp_amg_tpu/ops/pallas_routed.py:101's product)",
                     f"tile_csr:7pt{TILE_N}:L1-A:bf16:jacobi"),
             modes=[{k: r[k] for k in ("name", "ms", "plain_ms", "bound_us")}
                    for r in rows["tile_csr"]]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
