#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (omp_amg_tpu_torch).

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--n 128]

Phases (each raises on failure, so the exit code is non-zero):

1. the card's name and power limit; CUDA must be available;
2. builds both libraries from the sources in the checkout
   (``csrc/native.cc`` with g++, ``omp_amg_tpu_torch/csrc/*.cu`` with nvcc);
3. kernel checks: every kernel × mode × value type on the operators of the
   ``poisson3d_7pt(n)`` PMIS hierarchy, against its plain PyTorch twin on the
   same CUDA tensors, and both timed with CUDA events;
4. the main path: ``AMGSolver(A, AMGParams(coarsening="pmis"),
   device="cuda").solve(b, tol=1e-8)`` with launch counters reset just
   before and read just after; certified and scipy f64 residuals checked;
5. iteration parity of the GPU solve against the port's plain CPU solve at
   64³.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

DIA_BOUND = 1e-6    # ≤ 7 f32 terms summed: only the order may differ
CSR_BOUND = 1e-5    # rows of up to ~100 terms, summed in another order
SEED = 0            # right-hand side and kernel-check inputs
PARITY_N = 64       # the GPU/CPU iteration-parity grid
TPU_RECORD_64 = {"inner": 11, "outer": 2}   # bench_details.json
                                            # pmis_configs.3d7pt_64


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(fn, reps: int = 20, warm: int = 3, flush=None) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` warm calls, each
    between its own pair of CUDA events. With ``flush`` (a tensor larger
    than the 50 MB L2), the L2 is overwritten before every timed call, which
    also keeps the stream busy while the host enqueues the call."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def compare(name, kernel, plain, bound, nbytes, flush):
    """Run kernel and twin once, check the bound, time both with a cold L2;
    a result row."""
    import torch

    y = kernel()
    ref = plain()
    torch.cuda.synchronize()
    err = float((y - ref).abs().max()) if y.numel() else 0.0
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    ok = bool(torch.isfinite(y).all()) and err <= bound * max(scale, 1e-30)
    ms = cuda_ms(kernel, flush=flush)
    plain_ms = cuda_ms(plain, flush=flush)
    row = dict(name=name, max_abs_err=err, max_abs_ref=scale,
               rel_err=err / max(scale, 1e-30), ms=ms, plain_ms=plain_ms,
               gb_per_s=nbytes / ms / 1e6)
    print("check " + " ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in row.items()), flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its twin "
                             f"(max|Δ| {err:.3e} > {bound:g}·{scale:.3e})")
    return row


def kernel_checks(hier, rng):
    """Every kernel × mode × value type on the hierarchy's operators."""
    import torch

    from omp_amg_tpu_torch.ops import csr_spmv, dia_spmv
    from omp_amg_tpu_torch.sparse.formats import Csr, Dia

    dev = hier.device

    def vec(n):
        return torch.from_numpy(
            rng.standard_normal(n).astype(np.float32)).to(dev)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = {"dia_spmv": [], "csr_spmv": []}
    lv0 = hier.levels[0]
    if not isinstance(lv0.a, Dia):
        raise AssertionError("fine level is not banded")
    n = lv0.a.n_rows
    x, b = vec(n), vec(n)
    for dt in (torch.float32, torch.bfloat16):
        a = Dia(data=lv0.a.data.to(dt).contiguous(), offsets=lv0.a.offsets,
                dims=lv0.a.dims)
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        vb = a.data.numel() * a.data.element_size() + 8 * n
        cases = {
            "spmv": (lambda: dia_spmv.spmv(a, x),
                     lambda: dia_spmv.dia_spmv_plain(a, x), vb),
            "residual": (lambda: dia_spmv.residual(a, x, b),
                         lambda: dia_spmv.dia_spmv_plain(a, x, "residual", b),
                         vb + 4 * n),
            "jacobi": (lambda: dia_spmv.jacobi(a, x, b, lv0.s),
                       lambda: dia_spmv.dia_spmv_plain(a, x, "jacobi", b,
                                                       lv0.s),
                       vb + 8 * n),
        }
        for mode, (kern, plain, nbytes) in cases.items():
            rows["dia_spmv"].append(compare(
                f"dia_spmv:L0-A:{tag}:{mode}:n={n}", kern, plain, DIA_BOUND,
                nbytes, flush))

    for l, lv in enumerate(hier.levels):
        ops = [("P", lv.p), ("R", lv.r)]
        if isinstance(lv.a, Csr):
            ops.insert(0, ("A", lv.a))
        for opname, op in ops:
            m, k = op.shape
            x, b, v = vec(k), vec(m), vec(m)
            s = lv.s if opname == "A" else None
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
                        f"rows={m}:nnz={a.nnz}", kern, plain, CSR_BOUND,
                        nbytes, flush))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=128,
                    help="grid edge of the 3D 7-point Poisson main path")
    args = ap.parse_args()

    import torch

    # phase 1: the card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 1
    print(card_info(), flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import omp_amg_tpu_torch as amg
    from omp_amg_tpu_torch import _build, native
    from omp_amg_tpu_torch.ops import csr_spmv, dia_spmv

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

    params = amg.AMGParams(coarsening="pmis")
    rng = np.random.default_rng(SEED)

    # phase 3: kernel checks on the real level operators
    a = amg.poisson3d_7pt(args.n)
    hier = amg.amg_setup(a, params, device="cuda")
    rows = kernel_checks(hier, rng)
    del hier

    # phase 4: the main path, launch counters reset just before
    b = amg.default_rhs(a, seed=SEED)
    dia_spmv.launches = 0
    csr_spmv.launches = 0
    t0 = time.perf_counter()
    solver = amg.AMGSolver(a, params, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = solver.solve(b, tol=1e-8)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = {"dia_spmv": dia_spmv.launches, "csr_spmv": csr_spmv.launches}
    info = solver.last_info
    b64 = b.numpy().astype(np.float64)
    host_rel = float(np.linalg.norm(b64 - amg.dia_to_scipy(a) @ x)
                     / np.linalg.norm(b64))
    print(f"slice n={args.n}^3 sizes={solver.stats()['sizes']} "
          f"setup_s={setup_s:.3f} solve_s={solve_s:.3f} "
          f"inner_iters={info['inner_iters']} outer={info['outer_iters']} "
          f"certified_rel={info['rel_residual']:.3e} "
          f"scipy_rel={host_rel:.3e} launches={launches}", flush=True)
    if not (x.shape == (a.n_rows,) and np.isfinite(x).all()):
        raise AssertionError("solution has the wrong shape or is not finite")
    if info["rel_residual"] > 1e-8:
        raise AssertionError(f"certified rel {info['rel_residual']:.3e} > "
                             "1e-8")
    if host_rel > 2e-8:
        raise AssertionError(f"scipy f64 cross-check {host_rel:.3e} > 2e-8")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched by the solve")
    t0 = time.perf_counter()
    solver.solve(b, tol=1e-8)
    torch.cuda.synchronize()
    warm_solve_s = time.perf_counter() - t0
    r = b.to("cuda")
    vcycle_ms = cuda_ms(lambda: amg.vcycle(solver.hierarchy, r))
    print(f"slice warm_solve_s={warm_solve_s:.3f} vcycle_ms={vcycle_ms:.4f}",
          flush=True)
    del solver

    # phase 5: GPU/CPU iteration parity
    ap_ = amg.poisson3d_7pt(PARITY_N)
    bp = amg.default_rhs(ap_, seed=SEED)
    runs = {}
    for dev in ("cuda", "cpu"):
        s = amg.AMGSolver(ap_, params, device=dev)
        s.solve(bp, tol=1e-8)
        runs[dev] = s.last_info
    g, c = runs["cuda"], runs["cpu"]
    print(f"parity n={PARITY_N}^3 gpu inner={g['inner_iters']} "
          f"outer={g['outer_iters']} rel={g['rel_residual']:.3e} | "
          f"cpu inner={c['inner_iters']} outer={c['outer_iters']} "
          f"rel={c['rel_residual']:.3e} | TPU record (bench_details.json "
          f"pmis_configs.3d7pt_64) inner={TPU_RECORD_64['inner']} "
          f"outer={TPU_RECORD_64['outer']}", flush=True)
    if (g["inner_iters"], g["outer_iters"]) != (c["inner_iters"],
                                                c["outer_iters"]):
        for dev, run in runs.items():
            for k, hist in enumerate(run["residual_histories"]):
                print(f"parity history {dev} outer={k}: "
                      + " ".join(f"{h:.6e}" for h in hist))
        raise AssertionError("GPU and CPU iteration counts differ (histories "
                             "above: a difference of one must be traced to "
                             "reduction order before it is accepted)")

    if any(m.startswith(("jax", "omp_amg_tpu.")) or m == "omp_amg_tpu"
           for m in sys.modules):
        raise AssertionError("the JAX package was imported")

    def summary(name, source, replaces, main):
        main_row = next(r for r in rows[name] if r["name"].startswith(main))
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
                "ms": main_row["ms"], "plain_ms": main_row["plain_ms"]}

    print("kernels line: ms/plain_ms time dia_spmv:L0-A:bf16:spmv and "
          "csr_spmv:L1-A:f32:spmv with a cold L2; max_abs_err is the largest "
          "over all checks", flush=True)
    print(json.dumps({"kernels": [
        summary("dia_spmv", "omp_amg_tpu_torch/csrc/dia_spmv.cu",
                "omp_amg_tpu/ops/pallas_spmv.py:144",
                "dia_spmv:L0-A:bf16:spmv"),
        summary("csr_spmv", "omp_amg_tpu_torch/csrc/csr_spmv.cu",
                "omp_amg_tpu/ops/pallas_routed.py:101",
                "csr_spmv:L1-A:f32:spmv"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
