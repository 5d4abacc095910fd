"""The port stands alone: importing ``omp_amg_tpu_torch`` (every module of
it, the distributed ``parallel`` package, the ``remote_halo`` kernel
wrapper, the refresh, I/O, timers and CLI modules, the captured-block
runner, the multi-process entry and the scaling model included), running small CPU solves on its paths (classical PMIS
with the host and with the probed Galerkin values, structured with
``grid=``, structured on a 4-shard ``ShardMesh`` with the remote halo
transport, and a refreshed PMIS hierarchy) and the public sparse API
(``PROBLEMS``, ``dia_from_scipy``, ``dia_to_csr``, ``coo_to_csr``,
``csr_to_scipy``, ``diagonal``, ``spmv_csr``, ``spmv_dia``,
``vcycle_apply``) loads neither JAX nor the reference package
``omp_amg_tpu`` (the machine with the GPU has no JAX). Runs in a fresh
interpreter, since this test process has both loaded."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = """
import json, sys
import torch
torch.set_num_threads(2)
import omp_amg_tpu_torch as amg
import omp_amg_tpu_torch.ops.remote_halo
import omp_amg_tpu_torch.parallel.dist_ir
import omp_amg_tpu_torch.parallel.dist_setup
import omp_amg_tpu_torch.parallel.partition
import omp_amg_tpu_torch.parallel.multihost
import omp_amg_tpu_torch.parallel.scaling_model
import omp_amg_tpu_torch.amg.refresh
import omp_amg_tpu_torch.cli
import omp_amg_tpu_torch.utils.io
import omp_amg_tpu_torch.utils.timers
import omp_amg_tpu_torch.solvers.graph
infos = []
for n, kw in ((8, dict(params=amg.AMGParams(coarsening="pmis"))),
              (8, dict(params=amg.AMGParams(), grid=(8, 8, 8))),
              (12, dict(params=amg.AMGParams(coarsening="pmis",
                                             rap="probe"))),
              (16, dict(params=amg.AMGParams(), grid=(16, 16, 16),
                        mesh=amg.ShardMesh(4, "cpu"), transport="remote",
                        agg_rows_per_dev=64))):
    a = amg.poisson3d_7pt(n)
    solver = amg.AMGSolver(a, kw.pop("params"), device="cpu", **kw)
    solver.solve(amg.default_rhs(a, seed=0), tol=1e-8)
    infos.append({k: solver.last_info[k]
                  for k in ("iters", "outer_iters", "rel_residual")})
    infos[-1]["structured"] = type(solver.hierarchy.levels[0].p).__name__
a = amg.poisson3d_7pt(8)
solver = amg.AMGSolver(a, amg.AMGParams(coarsening="pmis"), device="cpu",
                       refreshable=True)
solver.refresh(amg.Dia(data=a.data * 2.0, offsets=a.offsets, dims=a.dims))
solver.solve(amg.default_rhs(a, seed=0), tol=1e-8)
infos.append({k: solver.last_info[k]
              for k in ("iters", "outer_iters", "rel_residual")})
infos[-1]["structured"] = "refreshed " + type(
    solver.hierarchy.levels[0].p).__name__
a = amg.PROBLEMS["2d5pt"](8)
d = amg.dia_from_scipy(amg.dia_to_scipy(a), device="cpu")
c = amg.dia_to_csr(d)
x = torch.ones(a.n_rows)
h = amg.amg_setup(a, amg.AMGParams(coarsening="pmis"), device="cpu")
api = [float((amg.spmv_csr(c, x) - amg.spmv_dia(d, x)).abs().max()),
       float(amg.diagonal(c).sum()), float(amg.diagonal(d).sum()),
       amg.csr_to_scipy(amg.coo_to_csr([0, 0], [0, 0], [1.0, 2.0], (1, 1),
                                       device="cpu")).toarray().tolist(),
       bool(torch.isfinite(amg.vcycle_apply(h, torch.zeros(a.n_rows),
                                            x)).all())]
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "omp_amg_tpu"))
print(json.dumps({"loaded": loaded, "infos": infos, "api": api}))
"""


def test_port_imports_no_jax_and_solves():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert ([i["structured"] for i in res["infos"]]
            == ["Csr", "GridProlong", "Csr", "SlabProlong", "refreshed Csr"])
    for info in res["infos"]:
        assert info["rel_residual"] <= 1e-8
        assert info["iters"] > 0
    assert res["api"] == [0.0, 256.0, 256.0, [[3.0]], True]
