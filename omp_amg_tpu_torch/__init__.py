"""omp_amg_tpu_torch — the PyTorch/CUDA port of omp_amg_tpu.

Classical (PMIS) AMG-PCG on one GPU: the host setup of the reference
(numpy plus ``csrc/native.cc``), and a device solve whose sparse work runs
through two hand-written CUDA kernels for Hopper (``csrc/dia_spmv.cu`` for
the banded fine level, ``csrc/csr_spmv.cu`` for every coarse A, P and R).
On CPU tensors the kernels' plain PyTorch twins run instead.

Imports torch, numpy and scipy; never JAX or ``omp_amg_tpu``.
"""

from .amg.hierarchy import Hierarchy, Level, amg_setup, hierarchy_stats  # noqa: F401
from .amg.params import AMGParams  # noqa: F401
from .amg.vcycle import vcycle  # noqa: F401
from .interop import hierarchy_from_numpy  # noqa: F401
from .problems.poisson import default_rhs, poisson3d_7pt, stencil_to_dia  # noqa: F401
from .solver import AMGSolver  # noqa: F401
from .solvers.cg import amg_pcg, pcg  # noqa: F401
from .solvers.ir import solve_ir  # noqa: F401
from .sparse.formats import Csr, Dia, dia_to_scipy  # noqa: F401
