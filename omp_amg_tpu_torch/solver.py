"""High-level solver facade (counterpart of the serial branch of
``omp_amg_tpu/solver.py::AMGSolver``).

    import omp_amg_tpu_torch as amg

    a = amg.poisson3d_7pt(128)
    solver = amg.AMGSolver(a, amg.AMGParams(coarsening="pmis"),
                           device="cuda")          # classical (PMIS)
    x = solver.solve(amg.default_rhs(a, seed=0), tol=1e-8)
    print(solver.last_info)
    solver = amg.AMGSolver(a, amg.AMGParams(), grid=(128, 128, 128),
                           device="cuda")          # structured

    solver = amg.AMGSolver(a, amg.AMGParams(coarsening="pmis", rap="probe"),
                           device="cuda")          # Galerkin values from the
                                                   # device numeric phase

    solver = amg.AMGSolver(a, amg.AMGParams(), grid=(128, 128, 128),
                           mesh=amg.ShardMesh(4, "cuda"),
                           transport="remote")     # z-slab distributed

    solver = amg.AMGSolver(a, amg.AMGParams(smoother="chebyshev",
                                            cycle="w"), grid=(128,) * 3)
    x = solver.solve(b, variant="pipelined",       # single-reduction PCG
                     device_result=True)           # x stays on the card

On CUDA the certified loop of a ``Dia`` operator forms its f64 residual on
the card (``residual="auto"``); ``residual="host"`` forms it on the host.

The device defaults to ``"cuda"``; without CUDA that raises, and nothing
moves to the CPU on its own: a CPU run passes ``device="cpu"`` (with a mesh,
``ShardMesh(d, "cpu")`` and ``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

from .amg.hierarchy import (
    Hierarchy, amg_setup, check_supported, fine_host_operator,
    fine_operator, hierarchy_stats,
)
from .amg.params import AMGParams
from .amg.vcycle import vcycle
from .native import CsrMatvec
from .solvers.cg import amg_pcg
from .solvers.ir import solve_ir, solve_ir_device
from .sparse.formats import Dia
from .utils.device import resolve_device


class AMGSolver:
    """AMG-preconditioned CG solver with amortized setup (classical PMIS or,
    with ``grid=``, structured hierarchy; f64-certified by default).

    With ``mesh`` (a :class:`~.parallel.mesh.ShardMesh` on ``device``), a
    structured problem builds and solves distributed over z-slabs: the
    per-shard setup (:func:`~.parallel.dist_setup.dist_structured_setup`),
    or, when that raises ValueError, the central setup partitioned
    (:mod:`~.parallel.partition`); the certified solve runs the sharded f64
    refinement loop (:mod:`~.parallel.dist_ir`). ``transport`` picks the
    halo exchange of the V-cycle and PCG: ``"ppermute"`` (plain copies) or
    ``"remote"`` (the ``remote_halo`` kernel).
    """

    def __init__(self, a, params: AMGParams = AMGParams(), *, device="cuda",
                 grid=None, mesh=None, transport: str = "ppermute",
                 agg_rows_per_dev: int = 2048, flavor: str = "host",
                 refreshable: bool = False):
        self.mesh = mesh
        self._dist = None
        self._dist_vcycle = None
        if mesh is not None:
            self._init_dist(a, params, device, grid, transport,
                            agg_rows_per_dev, flavor, refreshable)
            return
        if flavor != "host":
            raise NotImplementedError(f"flavor={flavor!r} is not ported yet")
        if refreshable and grid is not None:
            # the reference drops the flag silently on its structured mesh
            # path and fails later in refresh(); refuse it here instead
            raise ValueError("refreshable=True records the classical (PMIS) "
                             "setup; it does not combine with grid=")
        if refreshable:
            raise NotImplementedError("refreshable=True is not ported yet")
        check_supported(params)
        self.device = resolve_device(device)
        self.a = a
        self.params = params
        self.last_info: dict = {}
        self.hierarchy: Hierarchy = amg_setup(a, params, device=self.device,
                                              grid=grid)
        self._a_host = None
        self._a_f64 = None

    def _init_dist(self, a, params, device, grid, transport,
                   agg_rows_per_dev, flavor, refreshable):
        from .parallel.dist_setup import dist_structured_setup
        from .parallel.partition import partition_hierarchy, place_hierarchy
        from .parallel.slab import check_transport

        if refreshable:
            raise NotImplementedError("refreshable=True with mesh= (the "
                                      "distributed refresh) is not ported "
                                      "yet")
        if flavor != "host":
            raise NotImplementedError(f"flavor={flavor!r} is not ported yet")
        if params.coarsening == "pmis" or (
                params.coarsening == "auto"
                and (grid is None or not isinstance(a, Dia))):
            raise NotImplementedError("the distributed PMIS (classical) "
                                      "setup is not ported yet")
        check_supported(params)
        check_transport(transport)
        want = torch.device(device)
        if want.type != self.mesh.device.type or (
                want.index is not None
                and want.index != self.mesh.device.index):
            raise ValueError(f"device={str(want)!r} differs from the mesh's "
                             f"{str(self.mesh.device)!r}")
        self.device = self.mesh.device
        self.a = a
        self.params = params
        self.last_info = {}
        self._a_host = None
        self._a_f64 = None
        dh = None
        if grid is not None and isinstance(a, Dia):
            try:
                dh = dist_structured_setup(
                    a, grid, self.mesh, params, transport=transport,
                    agg_rows_per_dev=agg_rows_per_dev)
            except ValueError:
                dh = None
        if dh is None:
            hier = amg_setup(a, params, device=self.device, grid=grid)
            dh = place_hierarchy(
                partition_hierarchy(hier, self.mesh.size, transport=transport,
                                    agg_rows_per_dev=agg_rows_per_dev),
                self.mesh)
        self.hierarchy = dh

    @property
    def a_dev(self):
        """Device form of the fine operator (the hierarchy's level 0)."""
        if self.hierarchy.levels:
            return self.hierarchy.levels[0].a
        return fine_operator(self.a, self.device)

    @property
    def a_f64(self) -> Dia:
        """The fine ``Dia`` with float64 planes on the device, for the
        device certified loop (copied there once)."""
        if self._a_f64 is None:
            if not isinstance(self.a, Dia):
                raise TypeError("the device certified loop needs a Dia "
                                "operator")
            data = self.a.data if isinstance(self.a.data, torch.Tensor) \
                else torch.from_numpy(np.ascontiguousarray(self.a.data))
            self._a_f64 = Dia(data=data.to(self.device, torch.float64),
                              offsets=tuple(self.a.offsets),
                              dims=self.a.dims)
        return self._a_f64

    @property
    def a_host(self) -> CsrMatvec:
        """f64 host matvec of the fine operator (certified residuals)."""
        if self._a_host is None:
            m = fine_host_operator(self.a)
            self._a_host = CsrMatvec(m.indptr, m.indices, m.data,
                                     n_cols=m.shape[1])
        return self._a_host

    def stats(self) -> dict:
        if self.mesh is not None:
            sizes = [int(lv.a.n_rows) for lv in self.hierarchy.levels]
            sizes.append(int(self.hierarchy.coarse_chol.shape[0]))
            return {"levels": len(sizes), "sizes": sizes,
                    "sharded": [bool(lv.sharded)
                                for lv in self.hierarchy.levels]}
        return hierarchy_stats(self.hierarchy)

    def solve(self, b, tol: float = 1e-8, maxiter: int = 500,
              certify: bool = True, residual: str = "auto",
              device_result: bool = False, variant: str = "standard"):
        """Solve A x = b.

        ``certify=True`` (default) runs the f64 defect-correction outer loop,
        so the returned residual is a true f64 ‖r‖/‖b‖ ≤ tol; ``certify=
        False`` returns the f32 device solve as a tensor. ``residual`` picks
        where the certified loop forms its f64 residual: ``"host"`` (a host
        CSR product; x comes back as a float64 numpy array), ``"device"``
        (native f64 on the hierarchy's device; needs a ``Dia`` operator), or
        ``"auto"``: the device loop when the hierarchy is on CUDA and the
        operator is a ``Dia``, else the host loop. ``device_result=True``
        (device loop only) returns x as a float64 tensor on the device. On a
        mesh the certified loop always runs on the device. ``variant``:
        ``"standard"`` or ``"pipelined"`` (single-reduction) PCG.
        """
        if residual not in ("auto", "host", "device"):
            raise ValueError(f"residual={residual!r} (supported: auto, host, "
                             "device)")
        if self.mesh is not None:
            if residual == "host" or device_result:
                raise ValueError("the distributed certified loop forms its "
                                 "residual on the device and returns x on "
                                 "the host")
            if isinstance(b, torch.Tensor):
                b = b.detach().cpu().numpy()
            return self._solve_dist(b, tol, maxiter, certify, variant)
        on_device = residual == "device" or (
            residual == "auto" and isinstance(self.a, Dia)
            and self.device.type == "cuda")
        if device_result and not (certify and on_device):
            raise ValueError("device_result=True needs the certified device "
                             "loop (residual='device')")
        if certify:
            if on_device:
                res = solve_ir_device(self.a_f64, b, self.hierarchy, tol=tol,
                                      maxiter=maxiter, variant=variant,
                                      a_dev=self.a_dev,
                                      to_host=not device_result)
            else:
                if isinstance(b, torch.Tensor):
                    b = b.detach().cpu().numpy()
                res = solve_ir(self.a_host, np.asarray(b, np.float64),
                               self.a_dev, self.hierarchy, tol=tol,
                               maxiter=maxiter, variant=variant)
            self.last_info = {
                "iters": sum(res.inner_iters),
                "inner_iters": list(res.inner_iters),
                "outer_iters": res.outer_iters,
                "rel_residual": res.rel_residual,
                "certified_f64": True,
                "residual": "device" if on_device else "host",
                "residual_histories": res.histories,
            }
            return res.x
        rhs = torch.as_tensor(b).detach().to(self.device, torch.float32)
        res = amg_pcg(self.a_dev, rhs, self.hierarchy, tol=tol,
                      maxiter=maxiter, variant=variant)
        self.last_info = {
            "iters": res.iters,
            "rel_residual": res.rel_residual,
            "certified_f64": False,
        }
        return res.x

    def _solve_dist(self, b, tol, maxiter, certify, variant):
        from .parallel.dist import make_dist_solver
        from .parallel.dist_ir import make_dist_ir_solver
        from .parallel.partition import pad_vector, unpad_vector

        n = b.shape[0]
        bp = pad_vector(np.asarray(b, np.float64), self.hierarchy,
                        self.mesh.size)
        if certify:
            key = ("ir", tol, int(maxiter), variant)
            if self._dist is None or self._dist[0] != key:
                self._dist = (key, make_dist_ir_solver(
                    self.mesh, self.hierarchy, tol=tol, maxiter=maxiter,
                    variant=variant))
            res = self._dist[1](self.hierarchy, bp)
            self.last_info = {
                "iters": sum(res.inner_iters),
                "inner_iters": list(res.inner_iters),
                "outer_iters": res.outer_iters,
                "rel_residual": res.rel_residual,
                "certified_f64": True,
                "residual": "device",
                "distributed": True,
                "residual_histories": res.histories,
            }
            return unpad_vector(res.x, n)
        key = (int(maxiter), variant)
        if self._dist is None or self._dist[0] != key:
            self._dist = (key, make_dist_solver(self.mesh, self.hierarchy,
                                                tol=tol, maxiter=maxiter,
                                                variant=variant))
        rhs = torch.from_numpy(bp.astype(np.float32))
        res = self._dist[1](self.hierarchy, rhs, tol)
        self.last_info = {"iters": res.iters,
                          "rel_residual": res.rel_residual,
                          "certified_f64": False, "distributed": True}
        return unpad_vector(res.x, n)

    def precondition(self, r: torch.Tensor) -> torch.Tensor:
        """Apply one V-cycle: z = M⁻¹ r (for external Krylov loops)."""
        if self.mesh is not None:
            from .parallel.dist import make_dist_vcycle
            from .parallel.partition import pad_vector, unpad_vector

            if self._dist_vcycle is None:
                self._dist_vcycle = make_dist_vcycle(self.mesh,
                                                     self.hierarchy)
            n = r.shape[0]
            rp = pad_vector(r, self.hierarchy, self.mesh.size)
            return unpad_vector(self._dist_vcycle(self.hierarchy, rp), n)
        return vcycle(self.hierarchy, r)
