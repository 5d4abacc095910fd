"""Time ``panel_spmm``'s vector instance (C = 128) under several launch
bounds, on the operands of the 128³ PMIS probe setup.

The launch bound sets how many registers ptxas gives a thread, and with it
how many warps an SM keeps in flight to hide the X-row gathers. This script
builds ``omp_amg_tpu_torch/csrc/panel_spmm.cu`` once per candidate bound,
with the vector instance's ``__launch_bounds__(kThreads, kMinBlocks)``
replaced by the candidate and nothing else changed, into
``omp_amg_tpu_torch/_build/bounds/``; prints each build's registers and
spill bytes (ptxas); checks that every build gives the committed kernel's
bits; and times each on A·PV and R·U of the first colour group of levels 0
and 1 (cold L2, ``chip_smoke.cuda_ms``), in two rounds of opposite order. ``probe_us`` weighs the four as one probe
setup launches them (level 1 has two colour groups).

Needs an NVIDIA H100 and nvcc. Run from the repo root:

    python3 scripts/torch_panel_spmm_bounds.py
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
import omp_amg_tpu_torch as amg  # noqa: E402
from omp_amg_tpu_torch import _build  # noqa: E402
from omp_amg_tpu_torch.ops import panel_spmm as ps  # noqa: E402
from omp_amg_tpu_torch.ops import probe_rap as pr  # noqa: E402

KERNEL_BOUND = "__launch_bounds__(kThreads, kMinBlocks)"
BOUNDS = {"256": "__launch_bounds__(kThreads)",
          "256,4": "__launch_bounds__(kThreads, 4)",
          "256,5": "__launch_bounds__(kThreads, 5)",
          "256,6": "__launch_bounds__(kThreads, 6)",
          "256,8": "__launch_bounds__(kThreads, 8)",
          "1024": "__launch_bounds__(1024)"}
OUT = _build.BUILD_DIR / "bounds"


def build(tag: str):
    """(tag, library path, registers of the q = 4 instance, its spill
    bytes)."""
    src = (_build.CUDA_SOURCE_DIR / "panel_spmm.cu").read_text()
    if src.count(KERNEL_BOUND) != 1:
        raise RuntimeError(f"panel_spmm.cu no longer reads {KERNEL_BOUND}")
    name = tag.replace(",", "_")
    cu = OUT / f"panel_spmm_{name}.cu"
    cu.write_text(src.replace(KERNEL_BOUND, BOUNDS[tag]))
    lib = OUT / f"panel_spmm_{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                           "-v", "-o", str(lib), str(cu)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr[-2000:]}")
    # ptxas reports each entry: its name, then spill bytes, then registers
    entry = re.search(r"Compiling entry function '(\w*vec_kernelILi4E\w*)'"
                      r".*?(\d+) bytes spill stores.*?Used (\d+) registers",
                      proc.stderr, re.S)
    return tag, lib, int(entry.group(3)), int(entry.group(2))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_info(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(BOUNDS)) as pool:
        builds = list(pool.map(build, BOUNDS))
    libs = {}
    for tag, path, regs, spill in builds:
        lib = ctypes.CDLL(str(path))
        lib.panel_spmm_launch.argtypes = ([ctypes.c_int64, ctypes.c_int32,
                                           ctypes.c_int32]
                                          + [ctypes.c_void_p] * 6)
        lib.panel_spmm_launch.restype = ctypes.c_int32
        libs[tag] = (lib, regs, spill)

    _, host = amg.amg_setup(amg.poisson3d_7pt(128),
                            amg.AMGParams(coarsening="pmis"),
                            device="cuda", keep_host=True)
    ops = []
    for l in (0, 1):
        probe, _ = pr.build_rap_probe(host.ops[l], host.p[l], device="cuda")
        c0, width = probe.groups[0]
        x = pr.panel_pv(probe, c0, width)
        u = ps.spmm_panel(probe.a, x)
        ops += [(f"L{l}-A·PV", probe.a, x), (f"L{l}-R·U", probe.r, u)]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    for rnd, order in enumerate((list(libs), list(libs)[::-1])):
        for tag in order:
            lib, regs, spill = libs[tag]
            times = []
            for name, op, x in ops:
                out = torch.empty((op.n_rows, x.shape[1]), device="cuda")

                def call():
                    rc = lib.panel_spmm_launch(
                        op.n_rows, x.shape[1], ps.lane_plan(x.shape[1])[0],
                        op.indptr.data_ptr(), op.indices.data_ptr(),
                        op.vals.data_ptr(), x.data_ptr(), out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"{tag} {name}: cudaError {rc}")
                call()
                torch.cuda.synchronize()
                if not torch.equal(out, ps.spmm_panel(op, x)):
                    raise AssertionError(f"{tag} {name}: differs from the "
                                         "kernel")
                times.append(chip_smoke.cuda_ms(call, flush=flush) * 1e3)
            probe_us = times[0] + times[1] + 2 * (times[2] + times[3])
            print(f"bounds ({tag}) round={rnd} regs={regs} "
                  f"spill_bytes={spill} " + " ".join(
                      f"{name}_us={t:.2f}" for (name, _, _), t in
                      zip(ops, times)) + f" probe_us={probe_us:.1f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
