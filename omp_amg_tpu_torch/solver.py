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

The device defaults to ``"cuda"``; without CUDA that raises, and nothing
moves to the CPU on its own: a CPU run passes ``device="cpu"``.
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
from .solvers.ir import solve_ir
from .utils.device import resolve_device


class AMGSolver:
    """AMG-preconditioned CG solver with amortized setup (serial; classical
    PMIS or, with ``grid=``, structured hierarchy; f64-certified by
    default)."""

    def __init__(self, a, params: AMGParams = AMGParams(), *, device="cuda",
                 grid=None, mesh=None, flavor: str = "host",
                 refreshable: bool = False):
        if mesh is not None:
            raise NotImplementedError("distributed solve (mesh=) is not "
                                      "ported yet")
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

    @property
    def a_dev(self):
        """Device form of the fine operator (the hierarchy's level 0)."""
        if self.hierarchy.levels:
            return self.hierarchy.levels[0].a
        return fine_operator(self.a, self.device)

    @property
    def a_host(self) -> CsrMatvec:
        """f64 host matvec of the fine operator (certified residuals)."""
        if self._a_host is None:
            m = fine_host_operator(self.a)
            self._a_host = CsrMatvec(m.indptr, m.indices, m.data,
                                     n_cols=m.shape[1])
        return self._a_host

    def stats(self) -> dict:
        return hierarchy_stats(self.hierarchy)

    def solve(self, b, tol: float = 1e-8, maxiter: int = 500,
              certify: bool = True):
        """Solve A x = b.

        ``certify=True`` (default) runs the f64 defect-correction outer loop
        with host residuals, so the returned residual is a true f64
        ‖r‖/‖b‖ ≤ tol and x is a float64 numpy array; ``certify=False``
        returns the f32 device solve as a tensor.
        """
        if isinstance(b, torch.Tensor):
            b = b.detach().cpu().numpy()
        if certify:
            res = solve_ir(self.a_host, np.asarray(b, np.float64), self.a_dev,
                           self.hierarchy, tol=tol, maxiter=maxiter)
            self.last_info = {
                "iters": sum(res.inner_iters),
                "inner_iters": list(res.inner_iters),
                "outer_iters": res.outer_iters,
                "rel_residual": res.rel_residual,
                "certified_f64": True,
                "residual_histories": res.histories,
            }
            return res.x
        rhs = torch.from_numpy(np.asarray(b, np.float32)).to(self.device)
        res = amg_pcg(self.a_dev, rhs, self.hierarchy, tol=tol,
                      maxiter=maxiter)
        self.last_info = {
            "iters": res.iters,
            "rel_residual": res.rel_residual,
            "certified_f64": False,
        }
        return res.x

    def precondition(self, r: torch.Tensor) -> torch.Tensor:
        """Apply one V-cycle: z = M⁻¹ r (for external Krylov loops)."""
        return vcycle(self.hierarchy, r)
