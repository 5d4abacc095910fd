"""The port's multi-process mesh (``parallel/multihost.py``, ``ProcessMesh``)
against the one-process ``ShardMesh`` and the reference, on the CPU:

- the env gate: ``maybe_initialize(env={})`` is False; a degenerate
  one-process group in a subprocess is True, and True again (idempotent);
- the counterpart of ``tests/test_multihost_2proc.py``: two gloo processes
  on ``127.0.0.1``, each with ``global_mesh(4, "cpu")``, run
  ``dist_pmis_setup`` on ``poisson3d_7pt(24)`` (``agg_rows_per_dev=256``)
  and ``make_dist_solver(tol=1e-6, maxiter=100)``: both ranks report the
  same level sizes, iterations and residual, and x is bitwise a
  one-process ``ShardMesh(8, "cpu")`` run's, with equal counts;
- the facade's certified solve (``tol=1e-8``) on two processes × 2 shards,
  PMIS 16³ and z-slab 16³ (``ppermute``): counts and x bitwise the
  one-process ``ShardMesh(4)`` run's, and the counts the reference's
  serial ones on the same input;
- the refresh on the two-process PMIS solver (values ×2, then a pattern
  change that sets up afresh) and one V-cycle (``precondition``) of it:
  counts, x and the cycle's output bitwise the one-process mesh's;
- ``graph_stats`` on a process mesh: ``captured: False``, its reason, and
  the blocks of the one-process run's counts;
- ``transport="remote"`` on a CPU process mesh raises NotImplementedError
  (its kernel reads the neighbours' device memory through CUDA IPC).

The two processes run once for the whole file (a module fixture); each
has its own timeout.
"""

import json
import os
import socket
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import omp_amg_tpu as ref
from omp_amg_tpu.amg.params import AMGParams as RefParams
from omp_amg_tpu.solvers.ir import solve_ir as ref_solve_ir

import omp_amg_tpu_torch as port
from omp_amg_tpu_torch.parallel.dist import make_dist_solver
from omp_amg_tpu_torch.parallel.dist_pmis_setup import dist_pmis_setup
from omp_amg_tpu_torch.parallel.multihost import maybe_initialize
from omp_amg_tpu_torch.parallel.partition import pad_vector
from omp_amg_tpu_torch.solvers.graph import BLOCK

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120       # seconds, per subprocess
N_C, AGG_C = 24, 256
N_D, AGG_D = 16, 64
GRID_D = (N_D,) * 3

# shared by the child and the one-process runs in the test process
_HELPERS = r"""
def counts(solver):
    return {k: solver.last_info[k] for k in ("inner_iters", "outer_iters",
                                             "rel_residual")}


def refreshes(a):
    # values x2 (the value-only refresh), then a pattern change (the +x
    # coupling x1e-6 drops from the strength graph: a fresh setup)
    data = np.asarray(a.data)
    changed = data.copy()
    changed[list(a.offsets).index(1)] *= 1e-6
    return (("refresh", amg.Dia(data=data * 2.0, offsets=a.offsets,
                                dims=a.dims)),
            ("resetup", amg.Dia(data=changed, offsets=a.offsets,
                                dims=a.dims)))
"""
_shared = {"np": np, "amg": port}
exec(_HELPERS, _shared)
counts, refreshes = _shared["counts"], _shared["refreshes"]

_CHILD = r"""
import json, sys, warnings
import numpy as np
import torch
torch.set_num_threads(1)
from omp_amg_tpu_torch.parallel.multihost import global_mesh, maybe_initialize

assert maybe_initialize() is True
assert maybe_initialize() is True          # idempotent re-entry
import torch.distributed as dist
import omp_amg_tpu_torch as amg
from omp_amg_tpu_torch.parallel.dist import make_dist_solver
from omp_amg_tpu_torch.parallel.dist_pmis_setup import dist_pmis_setup
from omp_amg_tpu_torch.parallel.partition import pad_vector
from omp_amg_tpu_torch.solvers.graph import graph_stats
""" + _HELPERS + r"""
out, n_c, agg_c, n_d, agg_d = sys.argv[1], *map(int, sys.argv[2:])
rank = dist.get_rank()
res = {"world": dist.get_world_size(), "rank": rank}

a = amg.poisson3d_7pt(n_c)
mesh = global_mesh(4, "cpu")
dh = dist_pmis_setup(a, mesh.size, amg.AMGParams(coarsening="pmis"),
                     mesh=mesh, agg_rows_per_dev=agg_c)
res["sizes"] = [int(lv.a.n_rows) for lv in dh.levels]
res["local_blocks"] = len(dh.levels[0].a.blocks)
b = amg.default_rhs(a, seed=0)
r = make_dist_solver(mesh, dh, tol=1e-6, maxiter=100)(
    dh, pad_vector(b, dh, mesh.size))
res["c"] = [r.iters, r.rel_residual]
np.save(f"{out}/x_c_{rank}.npy", r.x.numpy())
res["graph"] = list(graph_stats(dh).values())
res["mesh_stats"] = dict(mesh.stats)

a = amg.poisson3d_7pt(n_d)
b = amg.default_rhs(a, seed=0)
mesh = global_mesh(2, "cpu")
solvers = {}
for label, kw in (("pmis", dict(params=amg.AMGParams(coarsening="pmis"),
                                refreshable=True)),
                  ("slab", dict(params=amg.AMGParams(), grid=(n_d,) * 3))):
    solver = solvers[label] = amg.AMGSolver(
        a, kw.pop("params"), mesh=mesh, device="cpu", agg_rows_per_dev=agg_d,
        **kw)
    x = solver.solve(b, tol=1e-8)
    res[label] = counts(solver)
    res[label]["sharded"] = solver.stats()["sharded"]
    res[label]["family"] = type(solver.hierarchy.levels[0].a).__name__
    np.save(f"{out}/x_{label}_{rank}.npy", x)
solver = solvers["pmis"]
for step, a_new in refreshes(a):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        solver.refresh(a_new)
    x = solver.solve(b, tol=1e-8)
    res[step] = counts(solver)
    res[step]["warned"] = any("re-setup" in str(m.message) for m in w)
    np.save(f"{out}/x_{step}_{rank}.npy", x)
np.save(f"{out}/x_precondition_{rank}.npy", solver.precondition(b).numpy())
try:
    amg.AMGSolver(a, amg.AMGParams(coarsening="pmis"), mesh=mesh,
                  device="cpu", transport="remote", agg_rows_per_dev=agg_d)
    res["remote"] = None
except NotImplementedError as e:
    res["remote"] = str(e)
print("RESULT " + json.dumps(res), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(port_, nprocs, rank):
    env = dict(os.environ, OMP_AMG_COORDINATOR=f"127.0.0.1:{port_}",
               OMP_AMG_NUM_PROCS=str(nprocs), OMP_AMG_PROC_ID=str(rank))
    env.pop("OMP_AMG_DIST", None)
    return env


def _launch(code, nprocs, args=()):
    """Run ``code`` in ``nprocs`` gated processes; [(rc, out, err)]."""
    port_ = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", code, *args],
                              env=_env(port_, nprocs, r), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(nprocs)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a {nprocs}-process run timed out after {TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.fixture(scope="module")
def two_procs(tmp_path_factory):
    out = tmp_path_factory.mktemp("multihost")
    runs = _launch(_CHILD, 2, [str(out), str(N_C), str(AGG_C), str(N_D),
                               str(AGG_D)])
    results = []
    for rc, stdout, err in runs:
        assert rc == 0, err[-3000:]
        line = next(ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT "))
        results.append(json.loads(line[len("RESULT "):]))
    return out, results


def _x(out, name):
    return [np.load(out / f"x_{name}_{r}.npy") for r in range(2)]


def test_noop_without_gate():
    assert maybe_initialize(env={}) is False


def test_degenerate_single_process_group():
    code = ("import torch.distributed as dist\n"
            "from omp_amg_tpu_torch.parallel.multihost import "
            "global_mesh, maybe_initialize\n"
            "assert maybe_initialize() is True\n"
            "assert dist.get_world_size() == 1 and dist.get_rank() == 0\n"
            "assert maybe_initialize() is True\n"
            "m = global_mesh(3, 'cpu')\n"
            "assert (m.size, m.first, m.local) == (3, 0, 3)\n"
            "print('MULTIHOST_OK', dist.get_backend())\n")
    ((rc, out, err),) = _launch(code, 1)
    assert rc == 0, err[-2000:]
    assert "MULTIHOST_OK gloo" in out


def test_two_process_pmis_setup_and_solve(two_procs):
    out, (r0, r1) = two_procs
    assert (r0["world"], r0["rank"], r1["rank"]) == (2, 0, 1)
    assert r0["local_blocks"] == 4          # this rank's shards only
    assert r0["sizes"] == r1["sizes"]
    assert r0["c"] == r1["c"]               # iterations and residual
    x0, x1 = _x(out, "c")
    assert np.array_equal(x0, x1)           # the full x on both ranks

    a = port.poisson3d_7pt(N_C)
    mesh = port.ShardMesh(8, "cpu")
    dh = dist_pmis_setup(a, 8, port.AMGParams(coarsening="pmis"), mesh=mesh,
                         agg_rows_per_dev=AGG_C)
    assert [int(lv.a.n_rows) for lv in dh.levels] == r0["sizes"]
    res = make_dist_solver(mesh, dh, tol=1e-6, maxiter=100)(
        dh, pad_vector(port.default_rhs(a, seed=0), dh, 8))
    assert [res.iters, res.rel_residual] == r0["c"]
    assert np.array_equal(res.x.numpy(), x0)      # bitwise
    assert r0["mesh_stats"]["calls"] > 0 and r0["mesh_stats"]["bytes"] > 0


def test_graph_stats_on_a_process_mesh(two_procs):
    _, (r0, r1) = two_procs
    iters = r0["c"][0]
    for r in (r0, r1):
        (st,) = r["graph"]
        assert st["captured"] is False
        assert "process mesh" in st["reason"]
        assert st["solves"] == 1
        assert st["blocks"] == -(-iters // BLOCK)
        assert st["frozen"] == st["blocks"] * BLOCK - iters


def _reference_serial(grid):
    a_j = ref.poisson3d_7pt(N_D, backend="numpy")
    b = port.default_rhs(port.poisson3d_7pt(N_D), seed=0).numpy().astype(
        np.float64)
    params = RefParams(coarsening="pmis") if grid is None else RefParams()
    solver_j = ref.AMGSolver(a_j, params, grid=grid)
    res = ref_solve_ir(solver_j.a_host, b, solver_j.a, solver_j.hierarchy,
                       tol=1e-8, maxiter=500)
    return list(res.inner_iters), res.outer_iters


@pytest.mark.parametrize("label", ["pmis", "slab"])
def test_facade_certified_on_two_processes(two_procs, label):
    out, (r0, r1) = two_procs
    assert r0[label] == r1[label]
    x0, x1 = _x(out, label)
    assert np.array_equal(x0, x1)
    a = port.poisson3d_7pt(N_D)
    b = port.default_rhs(a, seed=0)
    kw = (dict(params=port.AMGParams(coarsening="pmis")) if label == "pmis"
          else dict(params=port.AMGParams(), grid=GRID_D))
    solver = port.AMGSolver(a, kw.pop("params"), mesh=port.ShardMesh(4, "cpu"),
                            device="cpu", agg_rows_per_dev=AGG_D, **kw)
    x = solver.solve(b, tol=1e-8)
    info = solver.last_info
    assert r0[label]["family"] == type(solver.hierarchy.levels[0].a).__name__
    assert r0[label]["sharded"] == solver.stats()["sharded"]
    assert True in r0[label]["sharded"]
    assert (r0[label]["inner_iters"], r0[label]["outer_iters"]) == (
        info["inner_iters"], info["outer_iters"])
    assert r0[label]["rel_residual"] == info["rel_residual"] <= 1e-8
    assert np.array_equal(x, x0)            # bitwise the one-process mesh
    inner, outer = _reference_serial(None if label == "pmis" else GRID_D)
    assert (info["inner_iters"], info["outer_iters"]) == (inner, outer)


def test_remote_transport_on_a_cpu_process_mesh_raises(two_procs):
    _, (r0, r1) = two_procs
    for r in (r0, r1):
        assert r["remote"] and "CUDA IPC" in r["remote"]


def test_refresh_and_precondition_on_two_processes(two_procs):
    out, (r0, r1) = two_procs
    a = port.poisson3d_7pt(N_D)
    b = port.default_rhs(a, seed=0)
    solver = port.AMGSolver(a, port.AMGParams(coarsening="pmis"),
                            mesh=port.ShardMesh(4, "cpu"), device="cpu",
                            agg_rows_per_dev=AGG_D, refreshable=True)
    solver.solve(b, tol=1e-8)
    for step, a_new in refreshes(a):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            solver.refresh(a_new)
        x = solver.solve(b, tol=1e-8)
        want = dict(counts(solver),
                    warned=any("re-setup" in str(m.message) for m in w))
        assert want["warned"] == (step == "resetup")
        assert want["rel_residual"] <= 1e-8
        assert r0[step] == r1[step] == want
        x0, x1 = _x(out, step)
        assert np.array_equal(x0, x1)
        assert np.array_equal(x, x0)            # bitwise the one-process mesh
    z0, z1 = _x(out, "precondition")
    assert np.array_equal(z0, z1)
    assert np.array_equal(solver.precondition(b).numpy(), z0)
