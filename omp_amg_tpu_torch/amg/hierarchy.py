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
  rule, fixed here); on the card, an A or R of long rows whose
  neighbouring rows share their columns then takes the tiled form
  (``TileCsr``, the rule ``tile_rule``, applied in ``make_level``),
  recorded in ``Hierarchy.tiled``;
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
values from the device numeric phase (``ops/probe_rap.py``) on ``device``,
the phase ``L<l> RAP probe`` of the setup trace (the copy of its values to
the host is ``L<l> RAP probe copy``); the host product supplies the
pattern. Here the port departs from the reference: the reference keeps
the host values of a level whose colouring needs more than 256 colours (a
27-point operator's wide coarse rows), the port colours with no cap and
probes every level. ``"auto"`` and ``"host"`` keep the host values: the
reference's ``"auto"`` picks the probe only on a TPU.
``Hierarchy.rap_engines`` names the engine that gave each coarse operator's
values, recorded where the values are made, and the module's
``rap_products`` counts the products of the process by engine. Both PMIS
setups record each level's rows and stored nonzeros on the hierarchy
(``level_rows``, ``level_nnz``) from the host operators they hold.

``amg_setup(..., flavor="device")`` runs the setups' own kernels on
``device`` instead (the reference's device flavor): the PMIS setup's
strength, C/F split and direct interpolation, with the Galerkin product on
the host; the structured setup whole, every level's operator on the device
(``comb_rap.comb_rap_device``). Their ``dinv`` is a device tensor. Both
flavors, and the refresh, mark their phases in the opt-in setup trace
(``OMP_AMG_SETUP_TIMERS=1``, :func:`~.utils.trace.last_setup_trace`)
with the reference's labels, each phase a ``setup.<label>`` span.
"""

from __future__ import annotations

import collections
import contextlib
from dataclasses import dataclass
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from ..sparse.formats import (
    ConstDia, Csr, Dia, TileCsr, _numpy, csr_from_scipy,
    dia_planes_from_scipy, dia_to_device, dia_to_scipy, ell_planes,
    ell_planes_from_dia, ell_planes_from_scipy, ell_planes_to_scipy,
    tiled_form, to_const_dia,
)
from ..utils.device import resolve_device
from ..utils.trace import SetupTrace
from .params import AMGParams
from .comb_rap import comb_rap_device, dia_apply, structured_rap
from .structured import (
    GridProlong, GridRestrict, prolong_to_scipy, strong_axes,
    strong_axes_from_values,
)

BF16_MIN_ROWS = 1 << 22   # levels this large store coarse A, P, R in bf16
MAX_DENSE_ROWS = 1 << 12  # a structured coarsest level above coarse_size
                          # densifies up to this many rows (128 MiB in f64)

# Galerkin products of every setup and refresh of the process, by the engine
# that gave their values (``Hierarchy.rap_engines`` holds one hierarchy's)
rap_products = collections.Counter()


@dataclass(frozen=True)
class Level:
    a: Dia | Csr | ConstDia     # the level operator
    dinv: np.ndarray | torch.Tensor  # (n,) f32 inverse diagonal (l1jacobi:
                                     # the inverse row l1 norm): on the host,
                                     # or on the device from the device
                                     # setups (flavor="device")
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
    rap_engines: Tuple[str, ...] = ()   # per coarse operator, the engine
                                        # that gave its values: "host" (the
                                        # host product), "probe" (the device
                                        # numeric phase), "comb" (the device
                                        # structured RAP); empty where not
                                        # known (a hierarchy loaded or
                                        # converted)
    level_rows: Tuple[int, ...] = ()    # per level, the coarsest included:
    level_nnz: Tuple[int, ...] = ()     # the rows and stored nonzeros of
                                        # the operator as the setup made it
                                        # (the fine level's true nonzeros,
                                        # not DIA padding); recorded by the
                                        # PMIS setups, empty elsewhere

    @property
    def n_levels(self) -> int:
        return len(self.levels) + 1

    @property
    def device(self) -> torch.device:
        return self.coarse_chol.device

    @property
    def tiled(self) -> Tuple[Tuple[int, str, float], ...]:
        """(level, operator "a" or "r", unique share) of every operator in
        the tiled form (``TileCsr``): how often the rule engaged."""
        return tuple((l, name, op.unique_share)
                     for l, lv in enumerate(self.levels)
                     for name, op in (("a", lv.a), ("r", lv.r))
                     if isinstance(op, TileCsr))

    @property
    def tiled_nnz_share(self) -> float:
        """The share of the stored nonzeros of every level's A, P and R that
        sit in the tiled form. Stored: a ``Csr``'s or ``TileCsr``'s
        nonzeros, a ``Dia``'s nonzero plane entries (the recorded
        ``level_nnz`` where the setup kept it); the matrix-free ``ConstDia``
        and grid transfers store none."""
        def stored(op, l=None):
            if isinstance(op, (Csr, TileCsr)):
                return op.nnz
            if isinstance(op, Dia):
                if l is not None and l < len(self.level_nnz):
                    return self.level_nnz[l]
                return int((torch.as_tensor(op.data) != 0).sum())
            return 0
        total = tiled = 0
        for l, lv in enumerate(self.levels):
            for op in (lv.a, lv.p, lv.r):
                n = stored(op, l if op is lv.a else None)
                total += n
                tiled += n if isinstance(op, TileCsr) else 0
        return tiled / total if total else 0.0


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


def jacobi_scale(dinv, lmax, params: AMGParams):
    """s = ω·dinv in float32 (ω from :func:`jacobi_omega`): a host array,
    or for a device ``dinv`` (the device setups) a tensor on its device,
    the same f32 product."""
    omega = jacobi_omega(lmax, params)
    if isinstance(dinv, torch.Tensor):
        return float(omega) * dinv.to(torch.float32)
    return omega * np.asarray(dinv, np.float32)


def device_scale(a, v, device):
    """A per-row f32 vector on ``device``, or one float where ``a`` is a
    ``ConstDia`` and every row holds the same value (the stencil kernel's
    scalar operand). ``v``: a host array or a tensor."""
    if isinstance(v, torch.Tensor):
        v = v.to(device, torch.float32)
        if isinstance(a, ConstDia) and bool((v == v[0]).all()):
            return float(v[0])
        return v
    v = np.array(v, np.float32)         # an owned, writable copy
    if isinstance(a, ConstDia) and np.all(v == v[0]):
        return float(v[0])
    return torch.from_numpy(v).to(device)


def make_level(a, dinv, lmax, p, r, params: AMGParams, device) -> Level:
    """Level from its device operators, ``dinv`` (a host f64/f32 array, or
    an f32 tensor on the device from the device setups) and ``lmax``. A
    ``Csr`` A or R on the card takes the tiled form where the rule on the
    operator gives it (:func:`tiled_form`); the level then holds that form
    in place of the ``Csr``."""
    if isinstance(dinv, torch.Tensor):
        dinv = dinv.to(device, torch.float32)
    else:
        dinv = np.asarray(dinv, np.float32)
    a, r = tiled_form(a), tiled_form(r)
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


def is_structured(a, params: AMGParams, grid) -> bool:
    """Whether :func:`amg_setup` takes the structured path:
    ``coarsening="structured"``, or ``"auto"`` with a ``grid`` and a banded
    operator (a ``Dia``), as in the reference."""
    return (params.coarsening == "structured"
            or (params.coarsening == "auto" and grid is not None
                and isinstance(a, Dia)))


def amg_setup(a, params: AMGParams = AMGParams(), *, device="cuda",
              keep_host: bool = False, grid=None, cache=None,
              flavor: str = "host"):
    """Build the AMG hierarchy for ``a`` (a ``Dia``, numpy or torch planes,
    or a scipy sparse matrix) with its device forms on ``device`` (without
    CUDA, ``"cuda"`` raises RuntimeError; a CPU run passes
    ``device="cpu"``).

    ``flavor`` selects where the setup's own kernels run, with equivalent
    results: ``"host"`` (numpy and the native library, the default) or
    ``"device"`` (torch on ``device``). The device PMIS setup computes
    strength, the C/F split and direct interpolation (only: other
    ``interp`` values warn and use it) on the device and keeps the Galerkin
    product on the host; the device structured setup keeps every level's
    operator on the device (:func:`_amg_setup_structured`).

    ``grid`` (extents, C order) enables the structured coarsening for
    tensor-grid stencil operators. Selection follows ``params.coarsening``,
    as in the reference: "auto" is structured iff ``grid`` is given and the
    operator is banded, else classical (PMIS).

    ``cache`` (a :class:`~.refresh.SetupCache`) records the host-flavor
    PMIS setup's symbolic decisions per level (strength mask, C/F split, P
    pattern, the A_c, A·P and Pᵀ(A·P) patterns, the Pᵀ value permutation,
    the operator kinds), so that :func:`~.refresh.amg_refresh` can rebuild
    the values of a same-sparsity operator. With ``rap="probe"`` the cache
    records the host product's pattern, and a refresh computes A_c's
    values on the host, as the reference's does. A structured setup of
    either flavor records a :class:`~.refresh.StructuredCache` instead (its
    grids, axes and transfers, for
    :func:`~.refresh.structured_refresh`); the device-flavor PMIS setup
    refuses a cache (ValueError), as the reference's does.

    ``OMP_AMG_SETUP_TIMERS=1`` traces the setup's phases
    (:func:`~.utils.trace.last_setup_trace`).

    Returns ``Hierarchy``, and with ``keep_host=True`` also a ``HostSetup``.
    """
    import scipy.sparse as sp

    from ..ops.probe_rap import build_rap_probe
    from ..ops.rap import galerkin_product
    from ..utils.memtune import tune_malloc
    from . import host_setup as hs

    check_supported(params)
    if flavor not in ("host", "device"):
        raise ValueError(f"flavor must be 'host' or 'device', got "
                         f"{flavor!r}")
    structured = is_structured(a, params, grid)
    if cache is not None:
        from .refresh import SetupCache, StructuredCache

        if not isinstance(cache, StructuredCache if structured
                          else SetupCache) or not (structured
                                                   or flavor == "host"):
            raise ValueError(
                "a structured setup records a StructuredCache (either "
                "flavor), the host-flavor classical (PMIS) setup a "
                "SetupCache; the device-flavor PMIS setup keeps no record "
                "to refresh")
    if structured:
        n = a.n_rows if isinstance(a, Dia) else a.shape[0]
        if grid is None or int(np.prod(grid)) != n:
            raise ValueError("structured coarsening requires a matching grid")
    device = resolve_device(device)
    tune_malloc()   # setup temporaries recycle heap pages (see memtune)
    if structured:
        return _amg_setup_structured(a, tuple(int(g) for g in grid), params,
                                     device, keep_host, _STRUCTURED[flavor],
                                     cache=cache)
    if flavor == "device":
        return _amg_setup_pmis_device(a, params, device, keep_host)

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
        if cache is not None:
            # the refresh writes values into the device operator in
            # canonical CSR order: give it that order from the start
            from .refresh import canonical_csr

            a = a_sp = canonical_csr(a_sp)
        cur_planes = None
    if cache is not None:
        cache.start(a, a_sp)
    a_lvl = fine_operator(a, device)

    levels, engines = [], []   # engines: who gave each A_c its values
    sizes = []                 # (rows, nnz) of each level's A
    host = HostSetup(ops=[a_sp], states=[], p=[])
    trace = SetupTrace()
    while (a_sp.shape[0] > params.coarse_size
           and len(levels) < params.max_levels - 1):
        n = a_sp.shape[0]
        l = len(levels)
        with trace.phase(f"L{l} n={n} strength"):
            if cur_planes is None:
                cur_planes = ell_planes_from_scipy(a_sp,
                                                   dtype=np.float32)[:2]
            col, val = cur_planes
            mask = hs.strength_mask_host(col, val, params.theta)
        with trace.phase(f"L{l} pmis"):
            state = hs.pmis_host(col, mask,
                                 max_rounds=params.max_coarsen_rounds)
        is_c = (state == hs.CPOINT)
        cmap = np.cumsum(is_c.astype(np.int64)) - 1
        nc = int(is_c.sum())
        if nc == 0 or n / max(nc, 1) < params.min_coarsen_factor:
            break
        with trace.phase(f"L{l} interp"):
            if params.interp == "standard":
                p_col, p_val = hs.standard_interpolation_np(
                    col, val, mask, state, cmap, nc,
                    max_elements=params.interp_max_elements)
            elif params.interp == "extpi":
                p_col, p_val = hs.extpi_interpolation(
                    col, val, mask, state, cmap, nc,
                    max_elements=params.interp_max_elements)
            else:
                p_col, p_val = hs.direct_interpolation_np(
                    col, val, mask, state, cmap, nc)
            p_sp = ell_planes_to_scipy(p_col, p_val, nc)
        with trace.phase(f"L{l} transpose"):
            pt_sp = p_sp.T.tocsr()
        with trace.phase(f"L{l} RAP"):
            patterns = {} if cache is not None else None
            ac_sp = galerkin_product(a_sp, p_sp, pt_sp=pt_sp,
                                     patterns_out=patterns)
            if cache is not None:
                cache.record_level(mask=mask, state=state, cmap=cmap, nc=nc,
                                   p_col=p_col, p_val=p_val, p_sp=p_sp,
                                   ac_sp=ac_sp, patterns=patterns)
            if params.rap == "probe":
                probe, _ = build_rap_probe(a_sp, p_sp, ac_sp, device=device)
        if params.rap == "probe":
            ac_sp = _probe_values(trace, l, probe, ac_sp)
            engines.append("probe")
        else:
            engines.append("host")
        with trace.phase(f"L{l} lmax"):
            if params.smoother == "l1jacobi":
                dinv = 1.0 / np.asarray(np.abs(a_sp).sum(axis=1)).ravel()
            else:
                dinv = 1.0 / a_sp.diagonal()
            lmax = _estimate_lmax_host(a_sp, dinv)
        with trace.phase(f"L{l} operator form"):
            if a_lvl is None:
                a_lvl = csr_from_scipy(a_sp, _value_dtype(n), device=device)
            pr_dt = _value_dtype(n)
            levels.append(make_level(
                a_lvl, dinv, lmax,
                csr_from_scipy(p_sp, pr_dt, device=device),
                csr_from_scipy(pt_sp, pr_dt, device=device), params, device))
            sizes.append(_size(a_sp))
        if cache is not None:
            cache.levels[-1]["a_kind"] = type(a_lvl).__name__
        if keep_host:
            host.states.append(state)
            host.p.append(p_sp)
            host.ops.append(ac_sp)
        a_sp, a_lvl = ac_sp, None
        # the reference's label
        with trace.phase(f"L{len(levels)} next-planes"):
            cur_planes = ell_planes_from_scipy(ac_sp, dtype=np.float32)[:2]

    hier = _finish(levels, a_sp.toarray(), params, device, engines,
                   sizes + [_size(a_sp)])
    if cache is not None:
        cache.finish(hier, params)
    if keep_host:
        return hier, host
    return hier


def _finish(levels, dense, params: AMGParams, device, engines,
            sizes=()) -> Hierarchy:
    """The hierarchy over ``levels`` with the coarse-solve data of the
    densified coarsest operator ``dense`` (f64 host); ``engines`` names the
    engine of each level's Galerkin product, counted in ``rap_products``;
    ``sizes`` the (rows, nnz) of each level's operator, the coarsest
    included, or nothing."""
    fac = _coarse_factor(np.asarray(dense, np.float64), params)
    rap_products.update(engines)
    return Hierarchy(levels=tuple(levels),
                     coarse_chol=torch.from_numpy(
                         fac.astype(np.float32)).to(device),
                     params=params, rap_engines=tuple(engines),
                     level_rows=tuple(r for r, _ in sizes),
                     level_nnz=tuple(z for _, z in sizes))


def _size(a_sp) -> tuple:
    """(rows, stored nonzeros) of a scipy operator."""
    return int(a_sp.shape[0]), int(a_sp.nnz)


def _amg_setup_pmis_device(a, params: AMGParams, device, keep_host: bool):
    """The PMIS setup with its kernels on the device (the reference's
    ``flavor="device"``): per level, strength, the PMIS rounds, the coarse
    map and direct interpolation run on the device's ELL planes of A_l
    (:mod:`.strength`, :mod:`.pmis`, :mod:`.interp`; only ``nc`` and the
    round counts reach the host); P, a device ``Csr`` from its planes, is
    pulled to scipy for the host Galerkin product (or its device numeric
    phase, ``rap="probe"``); R is uploaded from Pᵀ; dinv and λmax (power
    iteration through the SpMV kernels) come from the device A_l, except
    with ``smoother="l1jacobi"``, whose row sums and λmax stay on the host
    as the reference's do. A_l is f32 on the device (the fine ``Dia`` bf16
    when lossless); the level keeps it, or its bf16 copy from 2²² rows,
    with P, as the host setup's forms."""
    import dataclasses
    import warnings

    from ..ops.probe_rap import build_rap_probe
    from ..ops.rap import galerkin_product
    from ..sparse.formats import csr_from_ell, csr_to_scipy, diagonal
    from .interp import direct_interpolation
    from .pmis import coarse_map, pmis
    from .smoothers import estimate_lmax
    from .strength import strength_mask

    if params.interp != "direct":
        warnings.warn(
            f"flavor='device' PMIS setup uses direct interpolation; "
            f"params.interp={params.interp!r} is host-flavor only",
            stacklevel=3)
    if isinstance(a, Dia):
        a_sp = ell_planes_to_scipy(*ell_planes_from_dia(a, dtype=np.float64))
    else:
        import scipy.sparse as sp

        a_sp = sp.csr_matrix(a, dtype=np.float64)
    a_dev = fine_operator(a, device)

    levels, engines = [], []   # engines: who gave each A_c its values
    sizes = []                 # (rows, nnz) of each level's A
    host = HostSetup(ops=[a_sp], states=[], p=[])
    trace = SetupTrace()
    while (a_sp.shape[0] > params.coarse_size
           and len(levels) < params.max_levels - 1):
        n = a_sp.shape[0]
        l = len(levels)
        # strength and the C/F split count in the reference's "interp"
        # phase, whose span opens once the level is known to coarsen
        col, val = ell_planes(a_dev)
        mask = strength_mask(col, val, params.theta)
        state = pmis(col, mask, max_rounds=params.max_coarsen_rounds)
        cmap, nc = coarse_map(state)
        if nc == 0 or n / max(nc, 1) < params.min_coarsen_factor:
            break
        with trace.phase(f"L{l} interp"):
            p_dev = csr_from_ell(*direct_interpolation(col, val, mask, state,
                                                       cmap), nc)
            del col, val, mask, cmap
            p_sp = csr_to_scipy(p_dev)
            p_sp.sort_indices()
        with trace.phase(f"L{l} transpose"):
            pt_sp = p_sp.T.tocsr()
        with trace.phase(f"L{l} RAP"):
            ac_sp = galerkin_product(a_sp, p_sp, pt_sp=pt_sp)
            if params.rap == "probe":
                probe, _ = build_rap_probe(a_sp, p_sp, ac_sp, device=device)
        if params.rap == "probe":
            ac_sp = _probe_values(trace, l, probe, ac_sp)
            engines.append("probe")
        else:
            engines.append("host")
        with trace.phase(f"L{l} lmax"):
            pr_dt = _value_dtype(n)
            r_dev = csr_from_scipy(pt_sp, pr_dt, device=device)
            if params.smoother == "l1jacobi":
                dinv = 1.0 / np.asarray(np.abs(a_sp).sum(axis=1)).ravel()
                lmax = _estimate_lmax_host(a_sp, dinv)
            else:
                dinv = 1.0 / diagonal(a_dev).to(torch.float32)
                lmax = estimate_lmax(a_dev, dinv)
        with trace.phase(f"L{l} operator form"):
            if pr_dt != torch.float32:
                p_dev = dataclasses.replace(p_dev, vals=p_dev.vals.to(pr_dt))
                if isinstance(a_dev, Csr):
                    a_dev = dataclasses.replace(a_dev,
                                                vals=a_dev.vals.to(pr_dt))
            levels.append(make_level(a_dev, dinv, lmax, p_dev, r_dev, params,
                                     device))
            sizes.append(_size(a_sp))
        if keep_host:
            host.states.append(state.cpu().numpy())
            host.p.append(p_sp)
            host.ops.append(ac_sp)
        a_sp = ac_sp
        a_dev = csr_from_scipy(ac_sp, torch.float32, device=device)

    hier = _finish(levels, a_sp.toarray(), params, device, engines,
                   sizes + [_size(a_sp)])
    return (hier, host) if keep_host else hier


def _probe_values(trace, l: int, probe, ac_sp):
    """A_c with its values from the device numeric phase. The phase
    ``L<l> RAP probe`` holds the numeric phase alone, marked when its
    device work ends; ``L<l> RAP probe copy`` selects the real slots of its
    planes on the device and copies them to the host once, as float64
    (row-major real slots are A_c's CSR order, because
    ``galerkin_product`` returns A_c zero-free and sorted)."""
    import scipy.sparse as sp

    from ..ops.probe_rap import rap_probe_numeric

    with trace.phase(f"L{l} RAP probe") as ph:
        planes = rap_probe_numeric(probe)
        ph.sync = planes
    with trace.phase(f"L{l} RAP probe copy"):
        vals = planes.masked_select(probe.ac_mask != 0).double().cpu()
    return sp.csr_matrix((vals.numpy(), ac_sp.indices.copy(),
                          ac_sp.indptr.copy()), shape=ac_sp.shape)


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
                          keep_host: bool, steps: _StructuredSteps,
                          cache=None, pinned=None):
    """Structured setup: semicoarsen the strong axes, grid transfers, the
    Galerkin planes, dinv from the centre plane (or the l1 sums) and λmax,
    and the form by :func:`_structured_form`, level by level. ``steps`` is
    the flavor (:data:`_STRUCTURED`): where the planes live and what
    computes the axes, the Galerkin planes and λmax.

    ``cache`` (a :class:`~.refresh.StructuredCache`) records what a refresh
    reuses: the fine dims and offsets, and per level its axes, coarse dims
    and transfers. ``pinned`` (a recorded cache) is the
    refresh's mode (:func:`~.refresh.structured_refresh`): the same loop
    over the recorded levels, with their axes and transfers, recomputing
    only what depends on the values, and the coarse factor marked as a
    phase of its own; a fine operator of other dims or offsets raises
    :class:`~.refresh.PatternChangedError` first. Both record, in the
    cache, each level's offsets and those of its Galerkin product
    (``planes``) and the hierarchy (``hier``).

    The coarsest level is densified (:func:`_structured_coarse`)."""
    offsets, data = steps.planes(a, device)
    n = int(np.prod(dims))
    if pinned is not None:
        pinned.check(a, offsets, n)
    if cache is not None:
        cache.start(dims, offsets, params, steps)
    host = HostSetup(ops=[fine_host_operator(a) if keep_host else None],
                     states=[], p=[])
    levels = []
    trail = []      # per level: its offsets and its Galerkin product's
    trace = SetupTrace()
    while (len(levels) < len(pinned.levels) if pinned is not None else
           n > params.coarse_size and len(levels) < params.max_levels - 1):
        k = len(levels)
        if pinned is None:
            with trace.phase(f"L{k} n={n} strength/axes"):
                axes = steps.axes(offsets, data, dims, params.theta)
            if not any(axes):
                break
            coarse_dims = tuple((d + 1) // 2 if c else d
                                for d, c in zip(dims, axes))
            p = GridProlong(fine_shape=dims, coarse_shape=coarse_dims,
                            coarsened=axes)
            r = GridRestrict(fine_shape=dims, coarse_shape=coarse_dims,
                             coarsened=axes)
        else:
            lv = pinned.levels[k]
            axes, coarse_dims, p, r = lv.axes, lv.coarse_dims, lv.p, lv.r
        if cache is not None:
            cache.record_level(axes, coarse_dims, p, r)
        with trace.phase(f"L{k} RAP") as ph:
            offs_c, data_c = steps.rap(ph, offsets, data, dims, coarse_dims,
                                       axes, p)
        trail.append((tuple(offsets), tuple(offs_c)))
        with trace.phase(f"L{k} lmax"):
            dinv = _level_dinv(offsets, data, params)
            cur, lmax = steps.lmax(offsets, data, dims, dinv)
        levels.append(_structured_level(trace, k, cur, dinv, lmax, p, r,
                                        params, device))
        offsets, data, dims = offs_c, data_c, coarse_dims
        n = int(np.prod(dims))
        if keep_host:
            host.ops.append(dia_to_scipy(Dia(data=data,
                                             offsets=tuple(offsets))))

    hier = _structured_coarse(trace, levels, offsets, data, dims, params,
                              device, steps.engine, pinned is not None)
    for record in (cache, pinned):
        if record is not None:
            record.planes, record.hier = trail, hier
    return (hier, host) if keep_host else hier


def _level_dinv(offsets, data, params: AMGParams):
    """A structured level's dinv from its planes: 1 / the centre plane, or
    1 / the row l1 norm with ``smoother="l1jacobi"`` (out-of-range taps are
    stored as exact zeros, so that norm is a plane-wise |·| sum)."""
    return 1.0 / (abs(data).sum(0) if params.smoother == "l1jacobi"
                  else data[list(offsets).index(0)])


def _structured_level(trace, k: int, cur, dinv, lmax, p, r,
                      params: AMGParams, device, checked=None) -> Level:
    """Level ``k`` of a structured setup from its f32 operator ``cur``,
    ``dinv`` and λmax, with its form (:func:`_structured_form`, ``checked``
    as there) marked as the phase ``L<k> operator form (<form>)``."""
    with trace.phase(f"L{k} operator form") as ph:
        a_lvl = _structured_form(cur, params, device, k, checked)
        ph.label += f" ({type(a_lvl).__name__})"
    return make_level(a_lvl, dinv, lmax, p, r, params, device)


def _structured_coarse(trace, levels, offsets, data, dims, params: AMGParams,
                       device, engine: str, refresh: bool) -> Hierarchy:
    """The structured hierarchy over ``levels``, its coarsest operator the
    planes ``data`` (``offsets``) on the grid ``dims``, densified. Where
    the loop ended above ``coarse_size`` (its strong axes down to 2
    points, or ``max_levels`` reached) that level is kept, as the
    reference keeps it, up to ``MAX_DENSE_ROWS`` rows; above both it
    raises ValueError instead of allocating. A refresh marks the coarse
    factor as a phase; the reference's setup marks none."""
    n = int(np.prod(dims))
    if n > max(params.coarse_size, MAX_DENSE_ROWS):
        raise ValueError(
            f"the structured setup ends at {n} rows (grid {dims}), above "
            f"coarse_size={params.coarse_size} and {MAX_DENSE_ROWS}: no axis "
            f"is left to coarsen or max_levels={params.max_levels} is "
            f"reached, and the dense coarse solve would take {8 * n * n} "
            "bytes")
    with (trace.phase("coarse factor") if refresh
          else contextlib.nullcontext()):
        return _finish(levels, _dense_from_planes(offsets, data, n), params,
                       device, (engine,) * len(levels))


def _structured_form(a: Dia, params: AMGParams, device, level: int,
                     checked=None):
    """The device form of a structured level's operator ``a`` (f32 planes,
    on the host or the device): a ``ConstDia`` where the reference's rule
    finds a masked-constant stencil (unless ``const_stencil="off"``), else
    a ``Dia`` (bf16 when lossless). ``checked``: ``(const, lossless)``,
    the two checks already made on these planes (``const`` as
    :func:`~.sparse.formats.to_const_dia` takes it, or None where the
    shape rules it out). Raises :class:`~.refresh.FormLimitError` (a
    ValueError) where the kernel's tap or diagonal limit is exceeded."""
    from ..ops.const_stencil import MAX_TAPS
    from ..ops.dia_spmv import MAX_DIAG
    from .refresh import FormLimitError

    const, lossless = checked if checked is not None else (None, None)
    a_lvl = (to_const_dia(a, device, const)
             if params.const_stencil != "off"
             and (checked is None or const is not None) else None)
    terms, limit, kernel = ((len(a_lvl.operand[1]), MAX_TAPS, "stencil")
                            if a_lvl is not None else
                            (len(a.offsets), MAX_DIAG, "DIA"))
    if terms > limit:
        raise FormLimitError(f"structured level {level} has {terms} "
                             f"diagonals, more than the {kernel} kernel's "
                             f"{limit}")
    return (a_lvl if a_lvl is not None else
            dia_to_device(a, device, lossless))


def _dense_from_planes(offsets, data, n: int) -> np.ndarray:
    """The coarsest operator densified from its diagonals (f64 host)."""
    data = np.asarray(_numpy(data), np.float64)
    dense = np.zeros((n, n), dtype=np.float64)
    for k, off in enumerate(offsets):
        i0, i1 = max(0, -off), min(n, n - off)
        if i1 > i0:
            idx = np.arange(i0, i1)
            dense[idx, idx + off] = data[k, i0:i1]
    return dense


class _StructuredSteps(NamedTuple):
    """The steps in which the structured setup's flavors differ; its level
    loop (:func:`_amg_setup_structured`) owns the rest."""
    planes: Callable    # (a, device) -> the fine operator's (offsets, planes)
    axes: Callable      # (offsets, planes, dims, theta) -> strong axes
    rap: Callable       # (phase, offsets, planes, dims, coarse_dims, axes,
                        #  p) -> the Galerkin (offsets, planes)
    lmax: Callable      # (offsets, planes, dims, dinv) -> (the level's f32
                        #  Dia, λmax)
    engine: str         # the Galerkin product's name in ``rap_engines``


def _host_planes(a, device):
    """f64 numpy planes of a ``Dia``, or of a scipy matrix's diagonals."""
    import scipy.sparse as sp

    if isinstance(a, Dia):
        return list(a.offsets), np.asarray(_numpy(a.data), dtype=np.float64)
    return dia_planes_from_scipy(sp.csr_matrix(a, dtype=np.float64))


def _host_axes(offsets, data, dims, theta):
    return strong_axes((offsets, data), dims, theta)


def _host_rap(phase, offsets, data, dims, coarse_dims, axes, p):
    """:func:`.comb_rap.structured_rap` on the f64 planes; the exact sparse
    product only when its probe rejects the radius-1 contract."""
    from ..ops.rap import galerkin_product

    try:
        offs_c, data_c = structured_rap(offsets, data, dims, coarse_dims,
                                        axes)
    except ValueError:
        cur_sp = dia_to_scipy(Dia(data=data, offsets=tuple(offsets)))
        offs_c, data_c = dia_planes_from_scipy(
            galerkin_product(cur_sp, prolong_to_scipy(p)))
    return offs_c, np.asarray(data_c)


def _host_lmax(offsets, data, dims, dinv):
    """λmax in float32 on the f32 planes, through the native kernel from
    2¹⁸ rows (as the reference: it sets ω, hence the iteration counts)."""
    from .. import native

    data_f = np.ascontiguousarray(data, np.float32)
    n = int(np.prod(dims))
    if n >= (1 << 18) and native.available():
        def apply_fn(v):
            return native.dia_apply(offsets, data_f, v)
    else:   # small levels: the per-call OpenMP spawn outweighs it
        def apply_fn(v):
            return dia_apply(offsets, data_f, v)
    return (Dia(data=data_f, offsets=tuple(offsets), dims=dims),
            _estimate_lmax_apply(apply_fn, dinv, n, dtype=np.float32))


def _device_planes(a, device):
    """f32 planes on ``device`` (the device flavor takes a ``Dia`` only)."""
    if not isinstance(a, Dia):
        raise TypeError("the device structured setup needs a Dia operator")
    return ([int(o) for o in a.offsets],
            torch.as_tensor(a.data).to(device, torch.float32))


def _device_axes(offsets, data, dims, theta):
    """The axes from the per-diagonal means of the nonzeros: the only
    per-level statistics read on the host."""
    means = data.sum(dim=1) / (data != 0).sum(dim=1).clamp_min(1)
    return strong_axes_from_values(offsets, means.cpu().numpy(), dims, theta)


def _device_rap(phase, offsets, data, dims, coarse_dims, axes, p):
    offs_c, data_c = comb_rap_device(offsets, data, dims, coarse_dims, axes)
    phase.sync = data_c
    return offs_c, data_c


def _device_lmax(offsets, data, dims, dinv):
    """λmax by power iteration through the DIA kernel on the f32 planes."""
    from .smoothers import estimate_lmax

    cur = Dia(data=data, offsets=tuple(offsets), dims=dims)
    return cur, estimate_lmax(cur, dinv)


# the structured setup's flavors: f64 host planes, or f32 device planes of
# which only the O(ndiag) statistics, the constant-stencil coefficients, the
# coarsest operator and (``keep_host=True``) each level reach the host
_STRUCTURED = {
    "host": _StructuredSteps(_host_planes, _host_axes, _host_rap,
                             _host_lmax, "host"),
    "device": _StructuredSteps(_device_planes, _device_axes, _device_rap,
                               _device_lmax, "comb"),
}


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
