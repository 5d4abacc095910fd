#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's z-slab halo exchange on the card, for the
port found under ``--root``, so that two commits can be compared in one run
on one card (for example this checkout and a ``git archive`` copy of its
parent, run in turns: parent, change, change, parent):

    python3 scripts/torch_halo_exchange.py --root . [--n 128]
    python3 scripts/torch_halo_exchange.py --root _archive/parent

It sets up the structured ``poisson3d_7pt(n)`` solve on ``ShardMesh(4)``
with ``transport="remote"``, as ``chip_smoke.py`` phase 10 does, and for
each sharded level's shape at d = 4 and level 0's at d = 8 times
``_exchange_planes_remote`` (the "remote" transport: every shard's window
``[left halo | rows | right halo]``) and ``_exchange_planes`` (the
"ppermute" transport) on the same random shards:

- ``*_us``: device µs per exchange by ``chip_smoke.py``'s ``cuda_ms``
  (the mean of 20 calls each between CUDA events after a 256 MB read
  that evicts the L2 and a ~1 ms spin);
- ``*_kernels``, ``*_busy_us``: device kernels and their device µs per
  exchange, from ``torch.profiler`` over 20 warm calls;
- ``*_host_us``: host µs per exchange over 1000 calls without a sync (the
  enqueue, ``chip_smoke.py``'s ``enqueue_us``).

Then it times 5 warm certified solves (``solve_s``). Needs one NVIDIA GPU;
prints the card's name and power limit first. Imports only the port
(never JAX).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

SHARDS = 4
REPS = 20
# chip_smoke.py beside this script: its timing method, whatever --root is
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import card_info, cuda_ms, enqueue_us  # noqa: E402


def profiled(torch, fn):
    """(kernels, device µs) per call of ``fn`` over REPS warm calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    return (sum(e.count for e in dev) / REPS,
            sum(e.self_device_time_total for e in dev) / REPS)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose omp_amg_tpu_torch is measured")
    ap.add_argument("--n", type=int, default=128, help="grid edge")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("torch.cuda is not available", file=sys.stderr)
        return 1
    import omp_amg_tpu_torch as amg
    from omp_amg_tpu_torch.parallel.slab import (
        _exchange_planes, _exchange_planes_remote,
    )

    pkg = os.path.dirname(os.path.abspath(amg.__file__))
    if os.path.dirname(pkg) != root:
        raise RuntimeError(f"imported {pkg}, not the port under {root}")
    print(f"{card_info()} | torch {torch.__version__} | port {pkg}",
          flush=True)
    n = args.n
    a = amg.poisson3d_7pt(n)
    solver = amg.AMGSolver(a, amg.AMGParams(), grid=(n,) * 3,
                           mesh=amg.ShardMesh(SHARDS, "cuda"),
                           device="cuda", transport="remote")
    shapes = [(f"L{l}", SHARDS, lv.a.data[0].shape[1], lv.a.plane, lv.a.hl,
               lv.a.hr) for l, lv in enumerate(solver.hierarchy.levels)
              if lv.sharded]
    lv0 = solver.hierarchy.levels[0].a
    shapes.append(("L0", 2 * SHARDS, n ** 3 // (2 * SHARDS), lv0.plane,
                   lv0.hl, lv0.hr))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(0)
    for tag, d, n_loc, plane, hl, hr in shapes:
        srcs = [torch.from_numpy(rng.standard_normal(n_loc)
                                 .astype(np.float32)).cuda()
                for _ in range(d)]
        got = _exchange_planes_remote(srcs, plane, hl, hr)
        want = _exchange_planes(srcs, plane, hl, hr)
        torch.cuda.synchronize()
        if not all(torch.equal(u, v) for u, v in zip(got, want)):
            raise AssertionError(f"{tag} d={d}: the transports differ")
        del got, want
        line = [f"exchange {tag} d={d} n_loc={n_loc} nl={hl * plane} "
                f"nr={hr * plane}"]
        for name, ex in (("remote", _exchange_planes_remote),
                         ("ppermute", _exchange_planes)):
            def fn(ex=ex):
                return ex(srcs, plane, hl, hr)
            us, host = cuda_ms(fn, flush=flush) * 1e3, enqueue_us(fn)
            kernels, busy = profiled(torch, fn)
            line.append(f"{name}_us={us:.2f} {name}_kernels={kernels:g} "
                        f"{name}_busy_us={busy:.2f} {name}_host_us={host:.2f}")
        print(" ".join(line), flush=True)
    b = amg.default_rhs(a, seed=0)
    solver.solve(b, tol=1e-8)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve(b, tol=1e-8)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    info = solver.last_info
    print(f"solve d={SHARDS} remote n={n}^3 inner={info['inner_iters']} "
          f"outer={info['outer_iters']} rel={info['rel_residual']:.3e} "
          f"solve_s=" + ",".join(f"{t:.4f}" for t in times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
