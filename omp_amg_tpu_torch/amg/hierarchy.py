"""AMG hierarchy containers and the host setups.

Counterpart of ``omp_amg_tpu/amg/hierarchy.py``: ``Level``/``Hierarchy``,
``_coarse_factor``, the host λmax estimators, the PMIS host branch and the
structured host branch of ``amg_setup``, and ``hierarchy_stats``. Both
setups run on the host exactly as the reference's do (numpy plus the native
kernels of ``csrc/native.cc``), so the coarsening, P and A_c are the
reference's. Only the device forms differ:

- PMIS: the fine A stays banded (``Dia``, diagonal-major), in bf16 when
  that cast is lossless, else f32; coarse A, P and R become ``Csr`` with f32
  values, or bf16 at levels of n ≥ 2²² rows (the reference's routed-ELL
  rule, fixed here);
- structured: a masked-constant 3D level becomes a ``ConstDia`` (the
  reference's detection rule), every other level a ``Dia`` as above; P and R
  are the grid transfers. The reference's TPU-only ``PlaneDia`` form is not
  needed: the diagonal-major ``Dia`` serves on the GPU;
- ``dinv`` is f32 on the host and ``lmax`` an f32 value. The Jacobi scale
  ``s = ω·dinv`` with ω = 4/(3·1.1·λmax) is precomputed in float32, as the
  reference's traced arithmetic computes it. ``dinv`` is the inverse
  diagonal, or with ``smoother="l1jacobi"`` the inverse row l1 norm
  1/Σ|a_ij|. On a ``ConstDia`` level whose ``s`` (and ``dinv``) is constant
  the device copy is one number; the l1 scale of a ``ConstDia`` varies at
  the grid boundary, so it stays a per-row tensor and the level runs the
  unfused sweep (the reference's ``const_scalar=False``);
- ``coarse_solver="inv"`` stores the symmetrized inverse of the coarsest
  operator in ``coarse_chol`` instead of its Cholesky factor.

With ``AMGParams(rap="probe")`` the PMIS setup takes each coarse operator's
values from the device numeric phase (``ops/probe_rap.py``) on ``device``;
the host product supplies the pattern, and the values of a level whose
colouring needs more than 256 colours. ``"auto"`` and ``"host"`` keep the
host values: the reference's ``"auto"`` picks the probe only on a TPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..sparse.formats import (
    ConstDia, Csr, Dia, csr_from_scipy, dia_planes_from_scipy, dia_to_device,
    dia_to_scipy, ell_planes_from_dia, ell_planes_from_scipy,
    ell_planes_to_scipy, to_const_dia,
)
from ..utils.device import resolve_device
from .params import AMGParams
from .structured import GridProlong, GridRestrict

BF16_MIN_ROWS = 1 << 22   # levels this large store coarse A, P, R in bf16


@dataclass(frozen=True)
class Level:
    a: Dia | Csr | ConstDia     # the level operator
    dinv: np.ndarray            # (n,) f32 inverse diagonal (l1jacobi: the
                                # inverse row l1 norm), on the host
    p: Csr | GridProlong        # prolongation to this level from level l+1
    r: Csr | GridRestrict       # restriction = Pᵀ
    lmax: float                 # f32 value: largest eigenvalue of D⁻¹A
    s: torch.Tensor | float     # Jacobi scale ω·dinv: (n,) f32, or one f32
                                # value (a float) on a ConstDia level where
                                # it is constant
    dinv_dev: torch.Tensor | float  # dinv on the device, in the form of s
                                    # (Chebyshev reads it)


@dataclass(frozen=True)
class Hierarchy:
    levels: Tuple[Level, ...]
    coarse_chol: torch.Tensor   # (nc, nc) f32 lower Cholesky factor, or
                                # the inverse (coarse_solver="inv")
    params: AMGParams

    @property
    def n_levels(self) -> int:
        return len(self.levels) + 1

    @property
    def device(self) -> torch.device:
        return self.coarse_chol.device


def check_supported(params: AMGParams) -> None:
    """Raise for parameter values the port does not implement: it runs the
    classical PMIS and the structured setups with the host Galerkin
    products (PMIS: or the device numeric phase, ``rap="probe"``), every
    smoother, cycle and coarse solve of the reference."""
    unsupported = {
        "coarsening": (params.coarsening, ("pmis", "auto", "structured")),
        "rap": (params.rap, ("auto", "host", "probe")),
        "smoother": (params.smoother, ("jacobi", "l1jacobi", "chebyshev")),
        "cycle": (params.cycle, ("v", "w", "f")),
        "coarse_solver": (params.coarse_solver, ("chol", "inv")),
        "interp": (params.interp, ("extpi", "standard", "direct")),
    }
    for name, (value, ok) in unsupported.items():
        if value not in ok:
            raise NotImplementedError(
                f"AMGParams.{name}={value!r} is not ported yet "
                f"(supported: {', '.join(ok)})")


def jacobi_omega(lmax, params: AMGParams) -> np.float32:
    """ω = params.omega or 4/(3·1.1·λmax), computed in float32 exactly as
    the reference's traced ``4.0 / (3.0 * 1.1 * lmax)`` (the Python
    constant 3.0·1.1 rounds to f32, then f32 ops)."""
    if params.omega is not None:
        return np.float32(params.omega)
    return np.float32(4.0) / (np.float32(3.0 * 1.1) * np.float32(lmax))


def jacobi_scale(dinv: np.ndarray, lmax, params: AMGParams) -> np.ndarray:
    """s = ω·dinv in float32 (ω from :func:`jacobi_omega`)."""
    return jacobi_omega(lmax, params) * np.asarray(dinv, np.float32)


def device_scale(a, v: np.ndarray, device):
    """A per-row f32 vector on ``device``, or one float where ``a`` is a
    ``ConstDia`` and every row holds the same value (the stencil kernel's
    scalar operand)."""
    v = np.array(v, np.float32)         # an owned, writable copy
    if isinstance(a, ConstDia) and np.all(v == v[0]):
        return float(v[0])
    return torch.from_numpy(v).to(device)


def make_level(a, dinv, lmax, p, r, params: AMGParams, device) -> Level:
    """Level from its device operators and host f64/f32 ``dinv``, ``lmax``."""
    dinv = np.asarray(dinv, np.float32)
    return Level(
        a=a, p=p, r=r, dinv=dinv, lmax=float(np.float32(lmax)),
        s=device_scale(a, jacobi_scale(dinv, lmax, params), device),
        dinv_dev=device_scale(a, dinv, device))


def _coarse_factor(dense: np.ndarray, params: AMGParams) -> np.ndarray:
    """Coarse-solve data from the densified coarsest operator (f64 host):
    the lower Cholesky factor (two triangular solves per application), or
    with ``coarse_solver="inv"`` the symmetrized inverse 0.5·(A⁻¹ + A⁻ᵀ)
    (one product per application; exact symmetry keeps the cycle SPD)."""
    chol = np.linalg.cholesky(dense)  # also validates SPD in both modes
    if params.coarse_solver == "inv":
        inv = np.linalg.inv(dense)
        return 0.5 * (inv + inv.T)
    return chol


def _estimate_lmax_host(a_sp, dinv: np.ndarray, iters: int | None = None
                        ) -> float:
    """Power iteration on D⁻¹A with the deterministic hash01 start vector.
    The matvec runs the native threaded CSR kernel when available (same
    per-row accumulation order as scipy's csr_matvec); norms and dots stay in
    numpy.

    ``iters=None`` adapts to the level size: 20 power sweeps below 2²²
    rows; at or above, a 12-step Lanczos on the symmetrized
    D^{-1/2}·A·D^{-1/2} (same spectrum, 12 matvecs instead of 21, a closer
    estimate)."""
    from ..native import CsrMatvec

    apply_a = CsrMatvec(a_sp.indptr, a_sp.indices, a_sp.data,
                        n_cols=a_sp.shape[1])
    n = a_sp.shape[0]
    if iters is None and n >= (1 << 22):
        return _lanczos_lmax_host(apply_a, dinv, n)
    return _estimate_lmax_apply(apply_a, dinv, n,
                                iters=20 if iters is None else iters)


def _lanczos_lmax_host(apply_a, dinv: np.ndarray, n: int, k: int = 12
                       ) -> float:
    """Largest Ritz value of D^{-1/2}·A·D^{-1/2} from a plain 3-term Lanczos
    recurrence (no reorthogonalization: extreme-eigenvalue estimates at
    k ≤ 12 are unaffected on these smooth SPD spectra)."""
    from .host_setup import hash01_np

    dsq = np.sqrt(dinv)

    def op(v):
        return dsq * apply_a(dsq * v)
    v = hash01_np(np.arange(n)).astype(np.float64) - 0.5
    v /= np.linalg.norm(v)
    alphas: list = []
    betas: list = []
    v_prev = np.zeros_like(v)
    beta = 0.0
    for _ in range(k):
        w = op(v)
        alpha = float(v @ w)
        w -= alpha * v + beta * v_prev
        alphas.append(alpha)
        beta = float(np.linalg.norm(w))
        if beta == 0.0:   # exact invariant subspace
            break
        betas.append(beta)
        v_prev, v = v, w / beta
    m = len(alphas)
    t = np.diag(alphas)
    if m > 1:
        off = np.asarray(betas[:m - 1])
        t += np.diag(off, 1) + np.diag(off, -1)
    return float(np.linalg.eigvalsh(t).max())


def _value_dtype(n_rows: int) -> torch.dtype:
    return torch.bfloat16 if n_rows >= BF16_MIN_ROWS else torch.float32


def fine_operator(a, device) -> Dia | Csr:
    """Device form of the fine operator: banded ``Dia`` stays banded (bf16
    when lossless), anything else becomes f32 ``Csr``."""
    if isinstance(a, Dia):
        return dia_to_device(a, device)
    return csr_from_scipy(a, torch.float32, device=device)


@dataclass(frozen=True)
class HostSetup:
    """Host record of a setup (``amg_setup(..., keep_host=True)``): per level
    the scipy operator A_l (f64; one more than the levels: the coarsest),
    and for the PMIS setup the C/F state and the scipy P_l."""

    ops: list
    states: list
    p: list


def amg_setup(a, params: AMGParams = AMGParams(), *, device="cuda",
              keep_host: bool = False, grid=None):
    """Build the AMG hierarchy for ``a`` (a numpy-backed ``Dia`` or a scipy
    sparse matrix) with its device forms on ``device`` (without CUDA,
    ``"cuda"`` raises RuntimeError; a CPU run passes ``device="cpu"``).

    ``grid`` (extents, C order) enables the structured coarsening for
    tensor-grid stencil operators. Selection follows ``params.coarsening``,
    as in the reference: "auto" is structured iff ``grid`` is given and the
    operator is banded, else classical (PMIS).

    Returns ``Hierarchy``, and with ``keep_host=True`` also a ``HostSetup``.
    """
    import scipy.sparse as sp

    from ..ops.rap import galerkin_product
    from ..utils.memtune import tune_malloc
    from . import host_setup as hs

    check_supported(params)
    structured = (params.coarsening == "structured"
                  or (params.coarsening == "auto" and grid is not None
                      and isinstance(a, Dia)))
    if structured:
        n = a.n_rows if isinstance(a, Dia) else a.shape[0]
        if grid is None or int(np.prod(grid)) != n:
            raise ValueError("structured coarsening requires a matching grid")
    device = resolve_device(device)
    tune_malloc()   # setup temporaries recycle heap pages (see memtune)
    if structured:
        return _amg_setup_structured(a, tuple(int(g) for g in grid), params,
                                     device, keep_host)

    if isinstance(a, Dia):
        # ELL planes + CSR straight from the diagonals (the reference's
        # numpy-Dia fast path): the planes keep DIA layout (slot = diagonal
        # index), which decides ext+i truncation ties
        c0, v64, _ = ell_planes_from_dia(a, dtype=np.float64)
        a_sp = ell_planes_to_scipy(c0, v64, a.n_rows)
        cur_planes = (c0, v64.astype(np.float32))
        del v64
    else:
        a_sp = sp.csr_matrix(a, dtype=np.float64)
        cur_planes = None
    a_lvl = fine_operator(a, device)

    levels = []
    host = HostSetup(ops=[a_sp], states=[], p=[])
    while (a_sp.shape[0] > params.coarse_size
           and len(levels) < params.max_levels - 1):
        n = a_sp.shape[0]
        if cur_planes is None:
            cur_planes = ell_planes_from_scipy(a_sp, dtype=np.float32)[:2]
        col, val = cur_planes
        mask = hs.strength_mask_host(col, val, params.theta)
        state = hs.pmis_host(col, mask, max_rounds=params.max_coarsen_rounds)
        is_c = (state == hs.CPOINT)
        cmap = np.cumsum(is_c.astype(np.int64)) - 1
        nc = int(is_c.sum())
        if nc == 0 or n / max(nc, 1) < params.min_coarsen_factor:
            break
        if params.interp == "standard":
            p_col, p_val = hs.standard_interpolation_np(
                col, val, mask, state, cmap, nc,
                max_elements=params.interp_max_elements)
        elif params.interp == "extpi":
            p_col, p_val = hs.extpi_interpolation(
                col, val, mask, state, cmap, nc,
                max_elements=params.interp_max_elements)
        else:
            p_col, p_val = hs.direct_interpolation_np(col, val, mask, state,
                                                      cmap, nc)
        p_sp = ell_planes_to_scipy(p_col, p_val, nc)
        pt_sp = p_sp.T.tocsr()
        ac_sp = galerkin_product(a_sp, p_sp, pt_sp=pt_sp)
        if params.rap == "probe":
            ac_sp = _probe_values(a_sp, p_sp, ac_sp, device)
        if params.smoother == "l1jacobi":
            dinv = 1.0 / np.asarray(np.abs(a_sp).sum(axis=1)).ravel()
        else:
            dinv = 1.0 / a_sp.diagonal()
        lmax = _estimate_lmax_host(a_sp, dinv)
        if a_lvl is None:
            a_lvl = csr_from_scipy(a_sp, _value_dtype(n), device=device)
        pr_dt = _value_dtype(n)
        levels.append(make_level(a_lvl, dinv, lmax,
                                 csr_from_scipy(p_sp, pr_dt, device=device),
                                 csr_from_scipy(pt_sp, pr_dt, device=device),
                                 params, device))
        if keep_host:
            host.states.append(state)
            host.p.append(p_sp)
            host.ops.append(ac_sp)
        a_sp, a_lvl = ac_sp, None
        cur_planes = ell_planes_from_scipy(ac_sp, dtype=np.float32)[:2]

    fac = _coarse_factor(np.asarray(a_sp.toarray(), np.float64), params)
    hier = Hierarchy(levels=tuple(levels),
                     coarse_chol=torch.from_numpy(
                         fac.astype(np.float32)).to(device),
                     params=params)
    if keep_host:
        return hier, host
    return hier


def _probe_values(a_sp, p_sp, ac_sp, device):
    """A_c with its values from the device numeric phase (f32 results, as
    float64, written in CSR order: ELL slot s of a row is CSR position s,
    because ``galerkin_product`` returns A_c zero-free and sorted), or
    ``ac_sp`` itself when the colouring exceeds the cap."""
    from ..ops.probe_rap import build_rap_probe, ell_slots, rap_probe_numeric

    probe, _ = build_rap_probe(a_sp, p_sp, ac_sp=ac_sp, device=device)
    if probe is None:
        return ac_sp
    vals = rap_probe_numeric(probe).cpu().numpy()
    out = ac_sp.copy()
    # row-major selection of the real slots = CSR order
    out.data = vals[ell_slots(ac_sp, vals.shape[1])].astype(np.float64)
    return out


def _estimate_lmax_apply(apply_fn, dinv: np.ndarray, n: int,
                         iters: int = 20, dtype=np.float64) -> float:
    """Power iteration on D⁻¹A through ``apply_fn`` in ``dtype`` (f64 for
    PMIS; the structured setup runs it in float32, as the reference does),
    from the deterministic hash01 start vector."""
    from .host_setup import hash01_np

    dinv = np.asarray(dinv, dtype)
    v = hash01_np(np.arange(n)).astype(dtype) - np.dtype(dtype).type(0.5)
    v /= np.linalg.norm(v)
    for _ in range(iters):
        w = dinv * apply_fn(v)
        v = w / np.linalg.norm(w)
    w = dinv * apply_fn(v)
    return float(v @ w / (v @ v))


def _amg_setup_structured(a, dims, params: AMGParams, device,
                          keep_host: bool):
    """Structured setup: semicoarsen the strong axes, grid transfers,
    Galerkin RAP on f64 numpy DIA planes (:func:`comb_rap.structured_rap`;
    the exact sparse product only when its probe rejects the radius-1
    contract). λmax runs in float32 on the f32 planes, through the native
    kernel from 2¹⁸ rows (as the reference: it sets ω, hence the iteration
    counts)."""
    import scipy.sparse as sp

    from .. import native
    from ..ops.const_stencil import MAX_TAPS
    from ..ops.dia_spmv import MAX_DIAG
    from ..ops.rap import galerkin_product
    from . import comb_rap as cr
    from .structured import prolong_to_scipy, strong_axes

    if isinstance(a, Dia):
        offsets = list(a.offsets)
        data = np.asarray(a.data, dtype=np.float64)
        a_sp = fine_host_operator(a) if keep_host else None
    else:
        a_sp = sp.csr_matrix(a, dtype=np.float64)
        offsets, data = dia_planes_from_scipy(a_sp)
    host = HostSetup(ops=[a_sp], states=[], p=[])
    levels = []
    n = int(np.prod(dims))
    while n > params.coarse_size and len(levels) < params.max_levels - 1:
        axes = strong_axes((offsets, data), dims, params.theta)
        if not any(axes):
            break
        coarse_dims = tuple((d + 1) // 2 if c else d
                            for d, c in zip(dims, axes))
        p = GridProlong(fine_shape=dims, coarse_shape=coarse_dims,
                        coarsened=axes)
        r = GridRestrict(fine_shape=dims, coarse_shape=coarse_dims,
                         coarsened=axes)
        try:
            offs_c, data_c = cr.structured_rap(offsets, data, dims,
                                               coarse_dims, axes)
        except ValueError:
            # operator outside the radius-1 contract → exact sparse product
            cur_sp = dia_to_scipy(Dia(data=data, offsets=tuple(offsets)))
            offs_c, data_c = dia_planes_from_scipy(
                galerkin_product(cur_sp, prolong_to_scipy(p)))
        if params.smoother == "l1jacobi":
            # out-of-range taps are stored as exact zeros: the row l1 norm
            # is a plane-wise |·| sum
            dinv = 1.0 / np.abs(data).sum(axis=0)
        else:
            dinv = 1.0 / data[offsets.index(0)]
        data_f = np.ascontiguousarray(data, np.float32)
        if n >= (1 << 18) and native.available():
            def apply_fn(v):
                return native.dia_apply(offsets, data_f, v)
        else:   # small levels: the per-call OpenMP spawn outweighs the work
            def apply_fn(v):
                return cr.dia_apply(offsets, data_f, v)
        lmax = _estimate_lmax_apply(apply_fn, dinv, n, dtype=np.float32)
        host_dia = Dia(data=data_f, offsets=tuple(offsets), dims=dims)
        a_lvl = (to_const_dia(host_dia, device)
                 if params.const_stencil != "off" else None)
        terms, limit, kernel = ((len(a_lvl.operand[1]), MAX_TAPS, "stencil")
                                if a_lvl is not None else
                                (len(offsets), MAX_DIAG, "DIA"))
        if terms > limit:
            raise ValueError(f"structured level {len(levels)} has {terms} "
                             f"diagonals, more than the {kernel} kernel's "
                             f"{limit}")
        if a_lvl is None:
            a_lvl = dia_to_device(host_dia, device)
        levels.append(make_level(a_lvl, dinv, lmax, p, r, params, device))
        offsets, data, dims = offs_c, np.asarray(data_c), coarse_dims
        n = int(np.prod(dims))
        if keep_host:
            host.ops.append(dia_to_scipy(Dia(data=data,
                                             offsets=tuple(offsets))))

    # densify the coarsest level directly from its diagonals
    dense = np.zeros((n, n), dtype=np.float64)
    for k, off in enumerate(offsets):
        i0, i1 = max(0, -off), min(n, n - off)
        if i1 > i0:
            idx = np.arange(i0, i1)
            dense[idx, idx + off] = data[k, i0:i1]
    fac = _coarse_factor(dense, params)
    hier = Hierarchy(levels=tuple(levels),
                     coarse_chol=torch.from_numpy(
                         fac.astype(np.float32)).to(device),
                     params=params)
    if keep_host:
        return hier, host
    return hier


def hierarchy_stats(hier: Hierarchy, host: HostSetup | None = None) -> dict:
    """Grid/operator complexities and per-level sizes."""
    sizes = ([lv.a.n_rows for lv in hier.levels]
             + [int(hier.coarse_chol.shape[0])])
    out = {"levels": len(sizes), "sizes": sizes}
    if host is not None:
        nnzs = [int(op.nnz) for op in host.ops]
        out["nnz"] = nnzs
        out["operator_complexity"] = float(sum(nnzs) / nnzs[0])
        out["grid_complexity"] = float(sum(sizes) / sizes[0])
    return out


def fine_host_operator(a):
    """scipy CSR (f64) of the fine operator, for the certified residual."""
    import scipy.sparse as sp

    if isinstance(a, Dia):
        return dia_to_scipy(a)
    return sp.csr_matrix(a, dtype=np.float64)
