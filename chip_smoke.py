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
   events;
4. the PMIS main path: ``AMGSolver(A, AMGParams(coarsening="pmis"),
   device="cuda").solve(b, tol=1e-8)``;
5. iteration parity of the PMIS GPU solve against the port's plain CPU
   solve at 64³;
6. ``const_stencil`` kernel checks: all five modes on the ``ConstDia`` of
   ``poisson3d_7pt(256)``, ``poisson3d_7pt(n)`` and ``poisson3d_27pt(n)``;
7. the 3D structured main path: ``AMGSolver(poisson3d_7pt(n), AMGParams(),
   grid=(n,)*3, device="cuda").solve(b, tol=1e-8)``; then ``dia_spmv``
   checks on its Galerkin levels;
8. the 2D structured path: the same call for ``poisson2d_5pt(1024)``; then
   ``dia_spmv`` checks on its fine and 512² operators (the operators the
   TPU's ``_dia_kernel`` serves);
9. iteration parity of the structured GPU solves against the port's plain
   CPU solves on ``bench.py``'s structured configs.

Each main path is driven with every launch counter set to 0 just before it
and read just after; certified and scipy f64 residuals are checked. The line
before the last is a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.
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
CONST_BOUND = 1e-6  # same products and order as the twin: expected 0
SEED = 0            # right-hand side and kernel-check inputs
PARITY_N = 64       # the PMIS GPU/CPU iteration-parity grid
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


def _vec(rng, n, dev):
    import torch

    return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)


def dia_checks(tag, a, s, rng, flush, dtypes):
    """All three ``dia_spmv`` modes × ``dtypes`` on the banded operator
    ``a`` (s: its Jacobi scale)."""
    import torch

    from omp_amg_tpu_torch.ops import dia_spmv
    from omp_amg_tpu_torch.sparse.formats import Dia

    n = a.n_rows
    x, b = _vec(rng, n, a.data.device), _vec(rng, n, a.data.device)
    rows = []
    for dt in dtypes:
        ad = Dia(data=a.data.to(dt).contiguous(), offsets=a.offsets,
                 dims=a.dims)
        vt = "bf16" if dt == torch.bfloat16 else "f32"
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
            rows.append(compare(
                f"dia_spmv:{tag}:{vt}:{mode}:n={n}:ndiag={len(a.offsets)}",
                kern, plain, DIA_BOUND, nbytes, flush))
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


def const_checks(tag, a, rng, flush):
    """All five ``const_stencil`` modes on the host operator ``a`` (a
    masked-constant 3D stencil), on the card, against the twin."""
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
    return [compare(f"const_stencil:{tag}:{mode}:n={n}:taps={len(cd.taps)}",
                    kern, pl, CONST_BOUND, nbytes, flush)
            for mode, (kern, pl, nbytes) in cases.items()]


def drive(label, a, params, grid, counters):
    """Drive one main path through the user's entry points: counters set to
    0 just before, read just after; certified and scipy f64 residuals
    checked; then a warm solve and the V-cycle time. Returns (solver,
    launches)."""
    import torch

    import omp_amg_tpu_torch as amg

    b = amg.default_rhs(a, seed=SEED)
    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    solver = amg.AMGSolver(a, params, grid=grid, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = solver.solve(b, tol=1e-8)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in counters.items()}
    info = dict(solver.last_info)
    b64 = b.numpy().astype(np.float64)
    host_rel = float(np.linalg.norm(b64 - amg.dia_to_scipy(a) @ x)
                     / np.linalg.norm(b64))
    forms = [type(lv.a).__name__ for lv in solver.hierarchy.levels]
    print(f"{label} sizes={solver.stats()['sizes']} forms={forms} "
          f"setup_s={setup_s:.3f} solve_s={solve_s:.3f} "
          f"inner_iters={info['inner_iters']} outer={info['outer_iters']} "
          f"certified_rel={info['rel_residual']:.3e} "
          f"scipy_rel={host_rel:.3e} launches={launches}", flush=True)
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
    solver.solve(b, tol=1e-8)
    torch.cuda.synchronize()
    warm_solve_s = time.perf_counter() - t0
    r = b.to("cuda")
    vcycle_ms = cuda_ms(lambda: amg.vcycle(solver.hierarchy, r))
    print(f"{label} warm_solve_s={warm_solve_s:.3f} "
          f"vcycle_ms={vcycle_ms:.4f}", flush=True)
    return solver, launches


def expect_launches(label, launches, used):
    """Every kernel in ``used`` launched, every other one not."""
    for name, count in launches.items():
        if (count > 0) != (name in used):
            raise AssertionError(f"{label}: {name} launched {count} times; "
                                 f"expected {'>0' if name in used else 0}")


def parity(label, a, params, grid, record=None):
    """The GPU solve's inner and outer counts against the port's own CPU
    solve; a difference prints both residual histories and fails."""
    import omp_amg_tpu_torch as amg

    b = amg.default_rhs(a, seed=SEED)
    runs = {}
    for dev in ("cuda", "cpu"):
        s = amg.AMGSolver(a, params, grid=grid, device=dev)
        s.solve(b, tol=1e-8)
        runs[dev] = s.last_info
    g, c = runs["cuda"], runs["cpu"]
    rec = "" if record is None else (
        f" | TPU record (bench_details.json) inner={record[0]} "
        f"outer={record[1]}")
    print(f"parity {label} gpu inner={g['inner_iters']} "
          f"outer={g['outer_iters']} rel={g['rel_residual']:.3e} | "
          f"cpu inner={c['inner_iters']} outer={c['outer_iters']} "
          f"rel={c['rel_residual']:.3e}{rec}", flush=True)
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
    print(card_info(), flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import omp_amg_tpu_torch as amg
    from omp_amg_tpu_torch import _build, native
    from omp_amg_tpu_torch.ops import const_stencil, csr_spmv, dia_spmv
    from omp_amg_tpu_torch.sparse.formats import bf16_lossless

    counters = {"const_stencil": const_stencil, "dia_spmv": dia_spmv,
                "csr_spmv": csr_spmv}

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
    rng = np.random.default_rng(SEED)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    # phase 3: PMIS kernel checks on the real level operators
    a = amg.poisson3d_7pt(args.n)
    hier = amg.amg_setup(a, pmis, device="cuda")
    rows = pmis_kernel_checks(hier, rng, flush)
    del hier

    # phase 4: the PMIS main path
    solver, pmis_launches = drive(f"pmis n={args.n}^3", a, pmis, None,
                                  counters)
    expect_launches("pmis", pmis_launches, ("dia_spmv", "csr_spmv"))
    del solver

    # phase 5: PMIS GPU/CPU iteration parity
    parity(f"pmis n={PARITY_N}^3", amg.poisson3d_7pt(PARITY_N), pmis, None,
           (TPU_RECORD_64["inner"], TPU_RECORD_64["outer"]))

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
    solver, s3_launches = drive(f"structured n={args.n}^3", a,
                                amg.AMGParams(), (args.n,) * 3, counters)
    expect_launches("structured 3D", s3_launches,
                    ("const_stencil", "dia_spmv"))
    for l, lv in enumerate(solver.hierarchy.levels[1:], 1):
        banded_checks(f"S3-L{l}-A", lv)
    del solver

    # phase 8: the 2D structured path, then dia_spmv on its 1024² and 512²
    # operators
    a2 = amg.poisson2d_5pt(N2D)
    solver, s2_launches = drive(f"structured 2D n={N2D}^2", a2,
                                amg.AMGParams(), (N2D, N2D), counters)
    expect_launches("structured 2D", s2_launches, ("dia_spmv",))
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

    if any(m.startswith(("jax", "omp_amg_tpu.")) or m == "omp_amg_tpu"
           for m in sys.modules):
        raise AssertionError("the JAX package was imported")

    launches = {name: pmis_launches[name] + s3_launches[name]
                + s2_launches[name] for name in counters}
    print(f"main-path launches: pmis={pmis_launches} "
          f"structured_3d={s3_launches} structured_2d={s2_launches}",
          flush=True)

    def summary(name, source, replaces, main):
        main_row = next(r for r in rows[name] if r["name"].startswith(main))
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
                "ms": main_row["ms"], "plain_ms": main_row["plain_ms"]}

    print(f"kernels line: launches sum the three main paths; ms/plain_ms "
          f"time const_stencil:7pt{CONST_N}:spmv, dia_spmv:L0-A:bf16:spmv "
          f"and csr_spmv:L1-A:f32:spmv with a cold L2; max_abs_err is the "
          f"largest over all checks", flush=True)
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
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
