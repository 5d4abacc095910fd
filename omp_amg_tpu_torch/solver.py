"""High-level solver facade (counterpart of
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

    solver = amg.AMGSolver(a, amg.AMGParams(coarsening="pmis"),
                           mesh=amg.ShardMesh(4, "cuda"),
                           transport="remote",     # PMIS row-sharded
                           refreshable=True)       # (per-shard setup)
    solver.refresh(a_new)                          # distributed refresh

    from omp_amg_tpu_torch.parallel.multihost import (
        global_mesh, maybe_initialize)
    maybe_initialize()                             # every process of a
    solver = amg.AMGSolver(a, amg.AMGParams(coarsening="pmis"),
                           mesh=global_mesh(2))    # launch: 2 shards each
    x = solver.solve(b)                            # the full x on every rank

    solver = amg.AMGSolver(a, amg.AMGParams(smoother="chebyshev",
                                            cycle="w"), grid=(128,) * 3)
    x = solver.solve(b, variant="pipelined",       # single-reduction PCG
                     device_result=True)           # x stays on the card

    solver = amg.AMGSolver(a, amg.AMGParams(coarsening="pmis"),
                           refreshable=True)       # PMIS, setup recorded
    solver.refresh(a_new)                          # same sparsity: values
                                                   # only

    solver = amg.AMGSolver(a, amg.AMGParams(), grid=(128,) * 3,
                           flavor="device",        # structured, grids
                           refreshable=True)       # recorded
    solver.refresh(a_shifted)                      # A + s·I on the same
                                                   # grid and offsets: the
                                                   # cached axes and
                                                   # transfers, new values

    solver = amg.AMGSolver(a, amg.AMGParams(), grid=(128,) * 3,
                           flavor="device")        # setup kernels on the
                                                   # card (PMIS: direct
                                                   # interpolation only)

On CUDA the certified loop of a ``Dia`` operator forms its f64 residual on
the card (``residual="auto"``); ``residual="host"`` forms it on the host.
On CUDA the inner PCG runs as captured blocks of iterations (CUDA graphs
cached on the hierarchy; ``solve(..., graph=False)`` runs the per-iteration
loop instead); a refresh drops the graphs with the hierarchy they read.

Under ``torch.profiler`` each public call is a span (``amg.solve``,
``amg.refresh``, ``amg.precondition``; the constructor's hierarchy build
``amg.setup``), the parent of the loops' spans (:mod:`.utils.trace`).

The device defaults to ``"cuda"``; without CUDA that raises, and nothing
moves to the CPU on its own: a CPU run passes ``device="cpu"`` (with a mesh,
``ShardMesh(d, "cpu")`` and ``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

from .amg.hierarchy import (
    Hierarchy, amg_setup, check_supported, fine_host_operator,
    fine_operator, hierarchy_stats, is_structured,
)
from .amg.params import AMGParams
from .amg.refresh import (
    PatternChangedError, SetupCache, StructuredCache, amg_refresh,
    structured_refresh,
)
from .amg.vcycle import vcycle
from .native import CsrMatvec
from .solvers.cg import amg_pcg, recapture
from .solvers.graph import captured_keys, drop_graphs
from .solvers.ir import solve_ir, solve_ir_device
from .sparse.formats import Dia
from .utils.device import resolve_device
from .utils.trace import span, traced


class AMGSolver:
    """AMG-preconditioned CG solver with amortized setup (classical PMIS or,
    with ``grid=``, structured hierarchy; f64-certified by default).

    With ``mesh`` (a :class:`~.parallel.mesh.ShardMesh` on ``device``; one
    over processes from :func:`~.parallel.multihost.global_mesh`, every
    rank calling with the same arguments), the problem builds and solves distributed: a structured one over z-slabs
    (the per-shard :func:`~.parallel.dist_setup.dist_structured_setup`), a
    classical one (``coarsening="pmis"``, or ``"auto"`` without a grid or a
    ``Dia``) by row blocks (the per-shard
    :func:`~.parallel.dist_pmis_setup.dist_pmis_setup`; with
    ``refreshable=True`` it records a ``DistSetupCache`` for
    :meth:`refresh`); when the per-shard setup raises ValueError, the
    central setup partitioned (:mod:`~.parallel.partition`). The certified
    solve runs the sharded f64 refinement loop (:mod:`~.parallel.dist_ir`)
    against the user's operator in float64; on a process mesh every rank
    gets the full x. ``transport`` picks the halo exchange of the V-cycle
    and PCG: ``"ppermute"`` (plain copies) or ``"remote"`` (the
    ``remote_halo`` kernel; between processes through CUDA IPC, so on the
    card only).

    ``flavor="device"`` runs the single-device setup's own kernels on the
    device (:func:`~.amg.hierarchy.amg_setup`); it raises ValueError with
    ``mesh``.

    ``refreshable=True`` records the setup for :meth:`refresh`. Three
    refreshes exist: on one device, the classical (PMIS) host setup's
    (``SetupCache``, :func:`~.amg.refresh.amg_refresh`) and the structured
    setup's of either flavor (``StructuredCache``,
    :func:`~.amg.refresh.structured_refresh`); on a mesh, the per-shard
    PMIS setup's (``DistSetupCache``). It raises ValueError with the
    device-flavor PMIS setup, which keeps no record, and with ``grid=`` on
    a mesh. ``refresh_counts`` counts the refreshes, ``{"refreshed": n,
    "fell_back": m}``: those that kept the recorded setup, and those that
    ran a fresh setup instead.
    """

    def __init__(self, a, params: AMGParams = AMGParams(), *, device="cuda",
                 grid=None, mesh=None, transport: str = "ppermute",
                 agg_rows_per_dev: int = 2048, flavor: str = "host",
                 refreshable: bool = False):
        self.mesh = mesh
        self.flavor = flavor
        self.refresh_counts = {"refreshed": 0, "fell_back": 0}
        self._dist = None
        self._dist_vcycle = None
        self._cache = None
        self._stage = None
        if flavor not in ("host", "device"):
            raise ValueError(f"flavor must be 'host' or 'device', got "
                             f"{flavor!r}")
        if flavor == "device" and mesh is not None:
            # the reference drops the flag silently on a mesh: refuse it
            raise ValueError("flavor='device' runs the single-device setup: "
                             "it does not combine with mesh=")
        structured = is_structured(a, params, grid)
        if refreshable and flavor == "device" and not structured:
            # the reference's setup cache refuses the device flavor
            raise ValueError("refreshable=True records the host PMIS setup "
                             "or a structured setup (grid=); the device "
                             "PMIS setup keeps no record to refresh")
        if refreshable and grid is not None and mesh is not None:
            # the reference drops the flag silently on its structured mesh
            # path and fails later in refresh(); refuse it here instead
            raise ValueError("refreshable=True on a mesh records the "
                             "per-shard PMIS setup; it does not combine "
                             "with grid=")
        check_supported(params)
        if mesh is not None:
            with span("amg.setup"):
                self._init_dist(a, params, device, grid, transport,
                                agg_rows_per_dev, refreshable)
            return
        self.device = resolve_device(device)
        self.a = a
        self.params = params
        self.last_info: dict = {}
        # refreshable: record the setup, so that refresh(a_new) recomputes
        # values only (amg/refresh.py)
        self._cache = ((StructuredCache() if structured else SetupCache())
                       if refreshable else None)
        with span("amg.setup"):
            self.hierarchy: Hierarchy = amg_setup(
                a, params, device=self.device, grid=grid, cache=self._cache,
                flavor=flavor)
        self._a_host = None
        self._a_f64 = None

    def _init_dist(self, a, params, device, grid, transport,
                   agg_rows_per_dev, refreshable):
        from .parallel.dist_pmis_setup import (
            DistSetupCache, dist_pmis_setup,
        )
        from .parallel.dist_setup import dist_structured_setup
        from .parallel.mesh import check_remote
        from .parallel.partition import partition_hierarchy, place_hierarchy
        from .parallel.slab import check_transport

        check_transport(transport)
        if transport == "remote":
            check_remote(self.mesh)
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
        if (grid is not None and isinstance(a, Dia)
                and params.coarsening in ("structured", "auto")):
            try:
                dh = dist_structured_setup(
                    a, grid, self.mesh, params, transport=transport,
                    agg_rows_per_dev=agg_rows_per_dev)
            except ValueError:
                dh = None
        use_pmis = params.coarsening == "pmis" or (
            params.coarsening == "auto"
            and (grid is None or not isinstance(a, Dia)))
        if dh is None and use_pmis:
            # the per-shard classical setup; a ValueError (an interpolation
            # it does not run) falls through to the central build
            dcache = DistSetupCache() if refreshable else None
            try:
                dh = dist_pmis_setup(a, self.mesh.size, params,
                                     mesh=self.mesh,
                                     agg_rows_per_dev=agg_rows_per_dev,
                                     transport=transport, cache=dcache)
                self._cache = dcache
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
    def dist_a_f64(self):
        """The user's fine operator in float64, per shard in the mesh
        hierarchy's level-0 layout, for the distributed certified loop
        (built once, at the first certified solve)."""
        if self._a_f64 is None:
            from .parallel.dist_ir import fine_f64

            self._a_f64 = fine_f64(self.a, self.hierarchy, self.device)
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

    @traced("amg.solve")
    def solve(self, b, tol: float = 1e-8, maxiter: int = 500,
              certify: bool = True, residual: str = "auto",
              device_result: bool = False, variant: str = "standard",
              graph: bool = True):
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
        ``"standard"`` or ``"pipelined"`` (single-reduction) PCG. ``graph``:
        on CUDA the captured PCG blocks (default) or, ``False``, the
        per-iteration loop.
        """
        if residual not in ("auto", "host", "device"):
            raise ValueError(f"residual={residual!r} (supported: auto, host, "
                             "device)")
        if self.mesh is not None:
            if residual == "host" or device_result:
                raise ValueError("the distributed certified loop forms its "
                                 "residual on the device and returns x on "
                                 "the host")
            if isinstance(b, torch.Tensor) and b.is_cuda:
                from .parallel.dist_ir import PinnedStage

                self._stage = self._stage or PinnedStage()
                b = self._stage.to_host(b.detach())
            elif isinstance(b, torch.Tensor):
                b = b.detach().numpy()
            return self._solve_dist(b, tol, maxiter, certify, variant, graph)
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
                                      to_host=not device_result, graph=graph)
            else:
                if isinstance(b, torch.Tensor):
                    b = b.detach().cpu().numpy()
                res = solve_ir(self.a_host, np.asarray(b, np.float64),
                               self.a_dev, self.hierarchy, tol=tol,
                               maxiter=maxiter, variant=variant, graph=graph)
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
                      maxiter=maxiter, variant=variant, graph=graph)
        self.last_info = {
            "iters": res.iters,
            "rel_residual": res.rel_residual,
            "certified_f64": False,
        }
        return res.x

    def _solve_dist(self, b, tol, maxiter, certify, variant, graph):
        from .parallel.dist import make_dist_solver
        from .parallel.dist_ir import make_dist_ir_solver
        from .parallel.partition import pad_vector, unpad_vector

        n = b.shape[0]
        bp = pad_vector(np.asarray(b, np.float64), self.hierarchy,
                        self.mesh.size)
        if certify:
            key = ("ir", tol, int(maxiter), variant, graph)
            if self._dist is None or self._dist[0] != key:
                self._dist = (key, make_dist_ir_solver(
                    self.mesh, self.hierarchy, self.dist_a_f64, tol=tol,
                    maxiter=maxiter, variant=variant, graph=graph))
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
        key = (int(maxiter), variant, graph)
        if self._dist is None or self._dist[0] != key:
            self._dist = (key, make_dist_solver(self.mesh, self.hierarchy,
                                                tol=tol, maxiter=maxiter,
                                                variant=variant, graph=graph))
        rhs = torch.from_numpy(bp.astype(np.float32))
        res = self._dist[1](self.hierarchy, rhs, tol)
        self.last_info = {"iters": res.iters,
                          "rel_residual": res.rel_residual,
                          "certified_f64": False, "distributed": True}
        return unpad_vector(res.x, n)

    @traced("amg.refresh")
    def refresh(self, a_new):
        """Value-only re-setup: the same sparsity, new operator values.

        Construct with ``refreshable=True``. A PMIS setup reuses every
        symbolic decision and device index tensor; a structured one its
        grids, axes and transfers (:func:`~.amg.refresh.structured_refresh`).
        When the new values change a strength, interpolation or Galerkin
        pattern, or a structured operator's grid or offsets, it warns and
        runs a fresh setup, with a new cache (``refresh_counts`` counts
        both outcomes). The certified loop then reads the new operator.
        The captured PCG graphs of the old hierarchy are dropped with it:
        they read its tensors. On one device the refresh captures the new
        hierarchy's graphs of the certified solves the old one had
        (:func:`~.solvers.cg.recapture`), into the memory pool the old ones
        held, so the next solve runs at once."""
        if self._cache is None:
            raise ValueError("construct AMGSolver(..., refreshable=True) "
                             "to enable refresh"
                             + (" (on a mesh: the classical PMIS setup)"
                                if self.mesh is not None else ""))
        old = self.hierarchy
        if self.mesh is not None:
            kept = self._refresh_dist(a_new)
        else:
            kept = self._refresh(a_new)
        self.refresh_counts["refreshed" if kept else "fell_back"] += 1
        keys = captured_keys(old)
        drop_graphs(old, self.hierarchy)
        if self.mesh is None:
            recapture(keys, old.levels[0].a if old.levels else None,
                      self.hierarchy)
        self.a = a_new
        self._a_host = None
        self._a_f64 = None
        return self

    def _refresh(self, a_new) -> bool:
        """The single-device branch of :meth:`refresh`: whether the
        recorded setup was kept."""
        structured = isinstance(self._cache, StructuredCache)
        try:
            self.hierarchy = (structured_refresh if structured
                              else amg_refresh)(a_new, self._cache)
            return True
        except PatternChangedError as e:
            import warnings

            warnings.warn(f"refresh pattern guard tripped ({e}); running "
                          "a full re-setup", stacklevel=3)
            # a structured operator on another grid brings its own dims
            grid = ((getattr(a_new, "dims", None) or self._cache.dims)
                    if structured else None)
            self._cache = StructuredCache() if structured else SetupCache()
            self.hierarchy = amg_setup(a_new, self.params, device=self.device,
                                       grid=grid, cache=self._cache,
                                       flavor=self.flavor)
            return False

    def _refresh_dist(self, a_new) -> bool:
        """The mesh branch of :meth:`refresh`: the per-shard value-only
        refresh (:func:`~.parallel.dist_pmis_setup.dist_pmis_refresh`), or
        on a pattern change a warning and a fresh per-shard setup; whether
        the recorded setup was kept."""
        from .parallel.dist_pmis_setup import (
            DistSetupCache, dist_pmis_refresh, dist_pmis_setup,
        )

        kept = True
        try:
            self.hierarchy = dist_pmis_refresh(a_new, self._cache)
        except PatternChangedError as e:
            kept = False
            import warnings

            warnings.warn(f"refresh pattern guard tripped ({e}); running "
                          "a full re-setup", stacklevel=3)
            part_kw = self._cache.part_kw
            self._cache = DistSetupCache()
            self.hierarchy = dist_pmis_setup(
                a_new, self.mesh.size, self.params, mesh=self.mesh,
                cache=self._cache, **part_kw)
        self._dist = None
        self._dist_vcycle = None
        return kept

    @traced("amg.precondition")
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
