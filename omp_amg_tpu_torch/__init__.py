"""omp_amg_tpu_torch — the PyTorch/CUDA port of omp_amg_tpu.

AMG-PCG on one GPU, on two paths, each with the reference's host setup
(numpy plus ``csrc/native.cc``) and a device solve whose sparse work runs
through hand-written CUDA kernels for Hopper (``csrc/*.cu``):

- classical (PMIS) coarsening: ``dia_spmv.cu`` for the banded fine level,
  ``csr_spmv.cu`` for every coarse A, P and R. With
  ``AMGParams(rap="probe")`` each coarse operator's values come from the
  device Galerkin numeric phase (colored probing, ``ops/probe_rap.py``):
  ``panel_spmm.cu`` computes the sparse × dense-panel products and
  ``extract_lanes.cu`` gathers A_c out of them;
- structured semicoarsening (``grid=``): ``const_stencil.cu`` for a
  matrix-free constant-stencil fine level, ``dia_spmv.cu`` for the banded
  Galerkin levels, and the grid transfers as torch slices;
- the same structured path distributed over z-slabs (``mesh=ShardMesh(d)``,
  :mod:`.parallel`): per-shard setup, sharded V-cycle and PCG, the f64
  certified outer loop; every shard-local product is one ``dia_spmv.cu``
  launch over its exchanged window, and ``transport="remote"`` writes the
  windows of all shards, halos included, in one ``remote_halo.cu`` launch;
- the classical path distributed by row blocks (``AMGParams(coarsening=
  "pmis")`` with ``mesh=``): the per-shard PMIS setup
  (``dist_pmis_setup``, with the value-only ``dist_pmis_refresh``), every
  shard's rows one ``csr_spmv.cu`` launch over its exchanged window, the
  windows again one ``remote_halo.cu`` launch under ``transport=
  "remote"``;
- both distributed paths on a mesh that spans processes
  (``parallel/multihost.py``: ``maybe_initialize`` and ``global_mesh``, a
  ``ShardMesh`` over a gloo group; several processes may share one
  card): bitwise the one-process mesh's results; ``transport="remote"``
  reads the neighbours' strips from their CUDA IPC mailboxes in the same
  ``remote_halo.cu`` launch. ``parallel/scaling_model.py`` predicts the
  weak scaling over cards from a hierarchy's per-level traffic.

On one device, ``flavor="device"`` (``AMGSolver``, ``amg_setup``, the
CLI's ``--setup-flavor device``) runs the setup's own kernels there too:
the PMIS setup's strength, C/F split and direct interpolation (the
Galerkin product stays on the host), or the whole structured setup, its
Galerkin product included; its λmax runs through ``dia_spmv.cu`` and
``csr_spmv.cu``. ``OMP_AMG_SETUP_TIMERS=1`` traces the setups' phases
(``last_setup_trace``); ``utils/trace.py`` holds that trace and the
program's spans on ``torch.profiler``'s timeline.

Every smoother (weighted and l1 Jacobi, Chebyshev), cycle (V, W, F),
coarse solve (Cholesky, inverse) and PCG variant (standard, pipelined) of
the reference runs on each path; the certified f64 outer loop forms its
residual on the host or, native f64, on the card.

A classical setup recorded in a ``SetupCache`` (``AMGSolver(...,
refreshable=True)``) refreshes its values for a same-sparsity operator
(``amg_refresh``, ``AMGSolver.refresh``), a structured one recorded in a
``StructuredCache`` for an operator on the same grid with the same
offsets (``structured_refresh``: the cached axes and transfers, new
Galerkin planes, smoother data and coarse factor); ``save_hierarchy`` and
``load_hierarchy`` checkpoint a hierarchy, ``read_matrix_market`` and
``write_matrix_market`` read and write operators, ``PhaseTimers`` times
phases, and ``python -m omp_amg_tpu_torch.cli`` is the command-line tool.

The entry points (``AMGSolver``, ``amg_setup``, ``hierarchy_from_numpy``,
``load_hierarchy``, ``read_matrix_market``, the CLI) run on the card by
default (``device="cuda"``) and raise without CUDA; a CPU run passes
``device="cpu"``, and on CPU tensors the kernels' plain PyTorch twins run
instead.

Imports torch, numpy and scipy; never JAX or ``omp_amg_tpu``.
"""

from .amg.hierarchy import (  # noqa: F401
    Hierarchy, Level, amg_setup, hierarchy_stats,
)
from .amg.params import AMGParams  # noqa: F401
from .amg.refresh import (  # noqa: F401
    PatternChangedError, SetupCache, StructuredCache, amg_refresh,
    cache_nbytes, structured_refresh,
)
from .amg.smoothers import chebyshev, estimate_lmax  # noqa: F401
from .amg.structured import GridProlong, GridRestrict  # noqa: F401
from .amg.vcycle import vcycle, vcycle_apply  # noqa: F401
from .interop import dist_hierarchy_from_numpy, hierarchy_from_numpy  # noqa: F401
from .parallel.dist_pmis_setup import (  # noqa: F401
    DistSetupCache, dist_pmis_refresh, dist_pmis_setup,
)
from .parallel.mesh import ShardMesh  # noqa: F401
from .ops.spmv import spmv, spmv_csr, spmv_dia  # noqa: F401
from .problems.poisson import (  # noqa: F401
    PROBLEMS, aniso2d_9pt, default_rhs, poisson2d_5pt, poisson3d_7pt, poisson3d_27pt,
    stencil_to_dia,
)
from .solver import AMGSolver  # noqa: F401
from .solvers.cg import amg_pcg, cg, pcg, pcg_pipelined  # noqa: F401
from .solvers.ir import solve_ir, solve_ir_device  # noqa: F401
from .sparse.formats import (  # noqa: F401
    ConstDia, Csr, Dia, const_to_dia, coo_to_csr, csr_from_scipy,
    csr_to_scipy, dia_from_scipy, dia_to_csr, dia_to_scipy, diagonal,
    to_const_dia,
)
from .utils.io import (  # noqa: F401
    load_hierarchy, read_matrix_market, save_hierarchy, write_matrix_market,
)
from .utils.timers import PhaseTimers  # noqa: F401
from .utils.trace import last_setup_trace  # noqa: F401
