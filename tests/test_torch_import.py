"""The port stands alone: importing ``omp_amg_tpu_torch`` (every module of
it, the distributed ``parallel`` package and the ``remote_halo`` kernel
wrapper included) and running small CPU solves on its paths (classical PMIS
with the host and with the probed Galerkin values, structured with
``grid=``, and structured on a 4-shard ``ShardMesh`` with the remote halo
transport) loads neither JAX nor the reference package ``omp_amg_tpu`` (the
machine with the GPU has no JAX). Runs in a fresh interpreter, since this
test process has both loaded."""

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
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "omp_amg_tpu"))
print(json.dumps({"loaded": loaded, "infos": infos}))
"""


def test_port_imports_no_jax_and_solves():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert ([i["structured"] for i in res["infos"]]
            == ["Csr", "GridProlong", "Csr", "SlabProlong"])
    for info in res["infos"]:
        assert info["rel_residual"] <= 1e-8
        assert info["iters"] > 0
