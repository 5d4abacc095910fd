"""AMG parameter set (reference's CLI knobs; SURVEY.md §5.6).

A frozen dataclass with the reference's fields, so that a same-field
parameter set converts field by field (``interop.py``, ``utils/io.py``).
Defaults are the classical-AMG textbook values the reference's configs imply
(θ=0.25, ω=2/3 weighted Jacobi, V(1,1), coarse direct solve ≤ 100 rows).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AMGParams:
    theta: float = 0.25          # strength-of-connection threshold
    smoother: str = "jacobi"     # "jacobi" | "chebyshev" | "l1jacobi"
                                 # (l1: D = diag of row-wise Σ|a_ij| —
                                 # unconditionally convergent on SPD,
                                 # BoomerAMG-style; ω default stays the
                                 # per-level auto formula)
    cycle: str = "v"             # "v" | "w" (γ=2) | "f" (F-cycle: one
                                 # F-recursion + one V-recursion per level)
    omega: float | None = None   # weighted-Jacobi damping; None = per-level
                                 # auto 4/(3·1.1·λmax) (≈2/3 for Poisson,
                                 # correct for operators with λmax(D⁻¹A)>2)
    nu_pre: int = 1              # pre-smoothing sweeps
    nu_post: int = 1             # post-smoothing sweeps
    cheby_degree: int = 3        # Chebyshev polynomial degree
    cheby_ratio: float = 30.0    # lower eigenvalue bound = lambda_max / ratio
    coarsening: str = "auto"     # "pmis" | "structured" | "auto"
    interp: str = "extpi"        # "direct" | "standard" (RS F-distribution)
                                 # | "extpi" (extended+i, distance-2 — best
                                 # measured: grid-flat iters, lowest op
                                 # complexity of the three)
    interp_max_elements: int = 6  # P row width cap (truncation, rescaled)
    coarse_size: int = 100       # dense direct solve below this many rows
    coarse_solver: str = "chol"  # "chol" (triangular solves) | "inv"
                                 # (precomputed symmetrized dense inverse:
                                 # one matrix-vector product)
    max_levels: int = 25
    max_structured_diags: int = 192  # no reader in the port: kept for
                                     # the same-field contract
    max_coarsen_rounds: int = 64  # PMIS round cap (safety)
    min_coarsen_factor: float = 1.02  # stop if a level shrinks less than this
    routed: str = "auto"         # no reader in the port (no routed-ELL
                                 # SpMV): kept for the same-field contract
    const_stencil: str = "auto"  # matrix-free ConstDia for levels whose
                                 # operator is a masked-constant stencil
                                 # (streams x and y only): "auto" | "off"
    rap: str = "auto"            # PMIS-path Galerkin numeric engine:
                                 # "auto" and "host" (native OpenMP
                                 # Gustavson on the host, f64) | "probe"
                                 # (the colored-probing device numeric
                                 # phase, ops/probe_rap.py, on every
                                 # level). The symbolic pattern always
                                 # comes from the host product (SURVEY
                                 # §4.2 two-phase split).
