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
  windows of all shards, halos included, in one ``remote_halo.cu`` launch.

Every smoother (weighted and l1 Jacobi, Chebyshev), cycle (V, W, F),
coarse solve (Cholesky, inverse) and PCG variant (standard, pipelined) of
the reference runs on each path; the certified f64 outer loop forms its
residual on the host or, native f64, on the card.

The entry points (``AMGSolver``, ``amg_setup``, ``hierarchy_from_numpy``)
run on the card by default (``device="cuda"``) and raise without CUDA; a CPU
run passes ``device="cpu"``, and on CPU tensors the kernels' plain PyTorch
twins run instead.

Imports torch, numpy and scipy; never JAX or ``omp_amg_tpu``.
"""

from .amg.hierarchy import Hierarchy, Level, amg_setup, hierarchy_stats  # noqa: F401
from .amg.params import AMGParams  # noqa: F401
from .amg.smoothers import chebyshev, estimate_lmax  # noqa: F401
from .amg.structured import GridProlong, GridRestrict  # noqa: F401
from .amg.vcycle import vcycle  # noqa: F401
from .interop import dist_hierarchy_from_numpy, hierarchy_from_numpy  # noqa: F401
from .parallel.mesh import ShardMesh  # noqa: F401
from .problems.poisson import (  # noqa: F401
    aniso2d_9pt, default_rhs, poisson2d_5pt, poisson3d_7pt, poisson3d_27pt,
    stencil_to_dia,
)
from .solver import AMGSolver  # noqa: F401
from .solvers.cg import amg_pcg, cg, pcg, pcg_pipelined  # noqa: F401
from .solvers.ir import solve_ir, solve_ir_device  # noqa: F401
from .sparse.formats import ConstDia, Csr, Dia, dia_to_scipy  # noqa: F401
