"""Command-line tool of the port (counterpart of ``omp_amg_tpu/cli.py``).

The reference's flags, defaults and choices, plus ``--device`` (``cuda``,
the default, or ``cpu``). Builds the problem (a generated grid operator or
a MatrixMarket file), sets up or loads the hierarchy, runs the certified
solve (or, with ``--no-ir``, the f32 PCG alone), times an SpMV of the fine
operator, and reports phase seconds, iterations, residuals and Gnnz/s, as
text or as one JSON line (``--json``) with the reference's keys.

Example:
    python -m omp_amg_tpu_torch.cli --problem 3d7pt --n 64 --tol 1e-8 --json

As in the reference, a generated problem's setup and inner solve see its
values rounded to f32, while the certified residual uses the f64 operator.
``--ir-residual auto`` forms that residual on the card (native f64,
``solve_ir_device``) for a generated problem on CUDA, else on the host.
``--setup-flavor device`` runs the setup's kernels on the device; when a
tiny host instance shows the stencil values f32-exact and the certified
residual runs on the device (``--ir-residual auto`` or ``device``, IR on),
the operator is generated on the device and no host planes are built: the
certified residual then uses those exact f32 values, in float64 on the
device. As the reference's, ``main`` first calls
:func:`~.parallel.multihost.maybe_initialize`, which wires the processes of
a multi-process launch together (env-gated; a no-op otherwise).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="omp_amg_tpu_torch",
                                description="AMG-PCG on a GPU (PyTorch/CUDA "
                                            "port of omp_amg_tpu)")
    p.add_argument("--problem", default="3d7pt",
                   choices=["2d5pt", "3d7pt", "3d27pt", "aniso9pt"],
                   help="test problem (BASELINE.json configs)")
    p.add_argument("--n", type=int, default=64, help="grid points per side")
    p.add_argument("--eps", type=float, default=1e-3,
                   help="anisotropy strength (aniso9pt)")
    p.add_argument("--matrix", default=None,
                   help="MatrixMarket file instead of a generated problem")
    p.add_argument("--theta", type=float, default=0.25)
    p.add_argument("--coarsening", default="auto",
                   choices=["auto", "pmis", "structured"],
                   help="auto = structured for generated grid problems, PMIS "
                        "for general matrices")
    p.add_argument("--smoother", default="jacobi",
                   choices=["jacobi", "chebyshev", "l1jacobi"])
    p.add_argument("--cycle", default="v", choices=["v", "w", "f"],
                   help="multigrid cycle shape (V / W / F)")
    p.add_argument("--pcg", default="standard",
                   choices=["standard", "pipelined"],
                   help="PCG variant (pipelined = single-reduction CG)")
    p.add_argument("--rap", default="auto",
                   choices=["auto", "host", "probe"],
                   help="PMIS Galerkin numeric engine: auto and host = host "
                        "Gustavson, probe = the device colored-probing "
                        "numeric phase on every level it fits")
    p.add_argument("--interp", default="extpi",
                   choices=["direct", "standard", "extpi"],
                   help="PMIS-path interpolation variant")
    p.add_argument("--setup-flavor", default="host",
                   choices=["host", "device"],
                   help="setup kernels: host numpy (default) or on the "
                        "device (PMIS: strength, C/F split and direct "
                        "interpolation; structured: every level, the "
                        "Galerkin product included)")
    p.add_argument("--omega", type=float, default=None,
                   help="Jacobi damping; default: per-level 4/(3*1.1*lmax)")
    p.add_argument("--nu", type=int, default=1, help="pre/post sweeps")
    p.add_argument("--cheby-degree", type=int, default=3)
    p.add_argument("--coarse-size", type=int, default=100)
    p.add_argument("--coarse-solver", default="chol",
                   choices=["chol", "inv"],
                   help="coarsest-level direct solve: Cholesky triangular "
                        "solves or one product with the inverse")
    p.add_argument("--max-levels", type=int, default=25)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--maxiter", type=int, default=500)
    p.add_argument("--rhs", default="random", choices=["random", "ones"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-ir", action="store_true",
                   help="single-precision PCG only (skip f64 refinement)")
    p.add_argument("--ir-residual", default="auto",
                   choices=["auto", "host", "device"],
                   help="where the f64 residual of the certified loop is "
                        "formed: host = native f64 SpMV; device = native f64 "
                        "on the device (generated problems); auto = device "
                        "for a generated problem on CUDA, else host")
    p.add_argument("--save-hierarchy", default=None)
    p.add_argument("--load-hierarchy", default=None)
    p.add_argument("--json", action="store_true", help="print JSON summary")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the solve phase "
                        "(view with tensorboard)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the hierarchy and the solve "
                        "(cuda, or cpu)")
    return p


def _profiler(path, device):
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(path))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    # multi-process entry: env-gated, a no-op for a single process
    from .parallel.multihost import maybe_initialize

    maybe_initialize()

    from . import native
    from .amg.hierarchy import amg_setup, fine_operator, hierarchy_stats
    from .amg.params import AMGParams
    from .ops.spmv import spmv
    from .problems.poisson import PROBLEMS, default_rhs
    from .solvers.cg import amg_pcg
    from .solvers.ir import solve_ir, solve_ir_device
    from .sparse.formats import Dia
    from .utils.device import resolve_device
    from .utils.timers import PhaseTimers, gnnz_per_s, timeit

    device = resolve_device(args.device)
    timers = PhaseTimers()
    with timers.phase("build"):
        grid = None
        if args.matrix:
            from .utils.io import read_matrix_market

            a_fine, a_sp = read_matrix_market(args.matrix, device=device)
            a_setup = a_sp
            apply64 = native.CsrMatvec(a_sp.indptr, a_sp.indices, a_sp.data,
                                       n_cols=a_sp.shape[1])
            a64 = None
            device_only = False
            b = torch.from_numpy(np.random.default_rng(args.seed)
                                 .standard_normal(a_sp.shape[0])
                                 .astype(np.float32))
        else:
            gen = PROBLEMS[args.problem]
            kw = {"eps": args.eps} if args.problem == "aniso9pt" else {}
            grid = (args.n,) * (3 if args.problem.startswith("3d") else 2)
            # the device-only build: f32-exact stencil values (checked on a
            # tiny host instance), the setup and the certified residual on
            # the device; the operator never exists on the host
            tiny = gen(4, **kw).data
            device_only = (bool(np.all(tiny.astype(np.float32) == tiny))
                           and args.setup_flavor == "device"
                           and not args.no_ir
                           and args.ir_residual in ("auto", "device"))
            if device_only:
                a64 = a_setup = gen(args.n, device=device, **kw)
            else:
                a64 = gen(args.n, **kw)
                # setup and inner solve on the f32-rounded values, the
                # certified residual on the f64 operator (as the reference)
                a_setup = Dia(data=a64.data.astype(np.float32).astype(
                    np.float64), offsets=a64.offsets, dims=a64.dims)

                def apply64(v):
                    return native.dia_apply(list(a64.offsets), a64.data, v)
            a_fine = fine_operator(a_setup, device)
            b = default_rhs(a64, args.rhs, args.seed)
        b_dev = b.to(device)

    params = AMGParams(theta=args.theta, smoother=args.smoother,
                       cycle=args.cycle, omega=args.omega, nu_pre=args.nu,
                       nu_post=args.nu, cheby_degree=args.cheby_degree,
                       coarsening=args.coarsening, interp=args.interp,
                       coarse_size=args.coarse_size,
                       coarse_solver=args.coarse_solver,
                       max_levels=args.max_levels, rap=args.rap)

    host = None
    # the device flavor keeps no host operators (as the reference's CLI)
    keep_host = a_fine.n_rows <= (1 << 20) and args.setup_flavor != "device"
    if args.load_hierarchy:
        from .utils.io import load_hierarchy

        with timers.phase("setup"):
            hier = load_hierarchy(args.load_hierarchy, device=device)
    else:
        holder: list = []
        with timers.phase("setup", holder):
            out = amg_setup(a_setup, params, device=device,
                            keep_host=keep_host, grid=grid,
                            flavor=args.setup_flavor)
            hier, host = out if keep_host else (out, None)
            holder.append(hier)
    if args.save_hierarchy:
        from .utils.io import save_hierarchy

        save_hierarchy(args.save_hierarchy, hier)
    stats = hierarchy_stats(hier, host)

    profile_ctx = (_profiler(args.profile, device) if args.profile
                   else contextlib.nullcontext())
    holder = []
    with profile_ctx, timers.phase("solve", holder):
        if args.no_ir:
            res = amg_pcg(a_fine, b_dev, hier, tol=args.tol,
                          maxiter=args.maxiter, variant=args.pcg)
            holder.append(res.x)
            iters, rel = res.iters, res.rel_residual
            b64 = b.numpy().astype(np.float64)
            ax = apply64(res.x.cpu().numpy().astype(np.float64))
            true_rel = float(np.linalg.norm(b64 - ax) / np.linalg.norm(b64))
        else:
            use_device = a64 is not None and (
                args.ir_residual == "device" or device_only
                or (args.ir_residual == "auto" and device.type == "cuda"))
            if use_device:
                res = solve_ir_device(a64, b_dev, hier, tol=args.tol,
                                      maxiter=args.maxiter,
                                      variant=args.pcg, a_dev=a_fine)
            else:
                res = solve_ir(apply64, b.numpy().astype(np.float64), a_fine,
                               hier, tol=args.tol, maxiter=args.maxiter,
                               variant=args.pcg)
            iters = sum(res.inner_iters)
            rel = true_rel = res.rel_residual

    # SpMV throughput on the fine operator (dia_spmv for a generated
    # problem, csr_spmv for a MatrixMarket file)
    nnz = int(a_sp.nnz) if args.matrix else int((torch.as_tensor(
        a64.data) != 0).sum())
    t_spmv = timeit(spmv, a_fine, b_dev, warmup=2, iters=10)

    summary = {
        "problem": args.problem if not args.matrix else args.matrix,
        "n_rows": int(a_fine.n_rows),
        "nnz": nnz,
        "levels": stats["levels"],
        "sizes": stats["sizes"],
        "operator_complexity": stats.get("operator_complexity"),
        "theta": args.theta,
        "coarsening": args.coarsening,
        "smoother": args.smoother,
        "tol": args.tol,
        "iters": iters,
        "rel_residual": rel,
        "true_rel_residual": true_rel,
        "timers_s": timers.report(),
        "spmv_seconds": t_spmv,
        "spmv_gnnz_per_s": gnnz_per_s(nnz, t_spmv),
        "backend": device.type,
    }
    if args.json:
        print(json.dumps(summary))
    else:
        for k, v in summary.items():
            print(f"{k:>22}: {v}")
    # success: converged in f64 truth, or (single-precision mode) the
    # recursive residual met the tolerance
    ok = true_rel <= args.tol * 10 or (args.no_ir and rel <= args.tol)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
