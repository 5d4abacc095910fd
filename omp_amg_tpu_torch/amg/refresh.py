"""Value-only hierarchy refresh (counterpart of
``omp_amg_tpu/amg/refresh.py``).

Time-dependent coefficients re-solve on the same sparsity. The symbolic
work of a classical (PMIS) host setup (strength graph, C/F split,
interpolation pattern, Galerkin patterns, the device index tensors) is
paid once by ``amg_setup(..., cache=SetupCache())``; each later
``amg_refresh(a_new, cache)`` recomputes values only.

The first refresh (cold) also freezes each level's numeric dataflow: the
CSR patterns of A, P, Pᵀ, A·P and Pᵀ·(A·P), and the value maps between
storage forms (the DIA → CSR selection ``dia_sel``, the CSR → ELL slot
positions ``ell_pos``, the P-ELL → CSR positions ``p_pos``, the Pᵀ value
permutation ``pt_perm``, the diagonal positions). Warm refreshes then run
numeric kernels only:

- strength and PMIS: skipped (the cached mask, state and coarse map);
  ``verify_mask`` recomputes the strength mask from the new values and
  compares;
- interpolation: the numeric ext+i (standard, direct) on the cached
  pattern, with a pattern-equality guard; ext+i rows whose near-tie
  truncation flipped are recomputed with the selection pinned to the
  cached pattern (``host_setup.extpi_pinned_rows``);
- Galerkin products: numeric-only native SpGEMMs into the cached A·P and
  Pᵀ·(A·P) patterns (``native.spgemm_numeric``); an entry the setup
  eliminated as an exact zero that comes back larger than
  ``DROPPED_TOL``·max|A_c| raises :class:`PatternChangedError`;
- λmax and the coarse factor: the setup's own ``_estimate_lmax_host`` and
  ``_coarse_factor``, so refreshed and fresh hierarchies agree to f32
  roundoff (tests pin it).

Every pattern guard raises :class:`PatternChangedError` (the facade then
runs a fresh setup); values are never written into a pattern they do not
fit, including a CSR operator whose ``indptr`` alone moved.
``OMP_AMG_SETUP_TIMERS=1`` traces the refresh's phases, with the
reference's labels (:func:`~.utils.trace.last_setup_trace`); each phase
is a ``setup.<label>`` span.

Device forms: a refreshed ``Csr`` is ``dataclasses.replace(old,
vals=new)``: its ``indptr`` and ``indices`` tensors are the cached
hierarchy's own, shared, not uploaded again. ``csr_from_scipy`` keeps
scipy's (sorted) CSR order, so each value stream is one host → device copy
in CSR order, rounded f64 → f32 (→ bf16 where the level stores bf16) as
the setup rounds it. R's values are P's, gathered on the device through
``pt_perm``: R costs no transfer. The fine ``Dia`` is rebuilt by
``fine_operator``, whose bf16-if-lossless rule can flip with the values
(the Poisson stencil is bf16-exact, ×1.7 of it is not); ``dinv``, ``s``
and ``dinv_dev`` come from ``make_level``. The cache keeps the newest
hierarchy, so a previous one's values are freed once its holder drops it.

A structured setup (``amg_setup(..., grid=, cache=StructuredCache())``,
either flavor) records its grids instead: the fine dims and offsets, and
per level the coarsened axes, the coarse dims and the grid transfers.
:func:`structured_refresh` runs the setup's own level loop over them
(``_amg_setup_structured``'s pinned mode), so a refreshed hierarchy is the
fresh setup of the new operator with the cached axes, bit for bit. The reference has no structured refresh.

Left out of the reference, because they exist only for its TPU relay and
the TPU's 16 GB of HBM: the routed-ELL refill (``_scatter_all_fn``,
``_refill_routed_all``, the routed ``_sort_map``/``_cast_stream``), the
bf16 value streams (``stream_dtype``, ``_resolve_stream_dtype``) and
``release_old_values`` (``_release_value_buffers``).

Differs from the reference on purpose: the dropped-Galerkin guard is
``DROPPED_TOL`` = 1e-7 (the reference's 1e-6 hides drift between 1e-7 and
1e-6 of the scale; the f32 residue of a ×1.7 change measures 1.4e-8 of
it); P's CSR pattern comes from the cached planes, never from the new
values, so a weight that cancels to zero stays an explicit zero and Pᵀ's
permutation cannot fall out of step; and the fine operator's offsets and
CSR pattern are checked against the setup's on the cold path too.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..sparse.formats import Csr, Dia, _numpy
from ..utils.trace import SetupTrace
from .params import AMGParams

DROPPED_TOL = 1e-7   # dropped-Galerkin guard, relative to max|A_c|


class PatternChangedError(RuntimeError):
    """The new values changed a symbolic decision (strength, interpolation
    truncation, a Galerkin or operator pattern): the cache cannot be
    applied."""


class FormLimitError(PatternChangedError, ValueError):
    """A structured level's planes need more taps than its kernel takes: a
    ValueError to a fresh setup, a pattern change to a refresh."""


def cache_nbytes(cache) -> int:
    """Host bytes of a setup cache's numpy state (per-level patterns,
    masks, value maps): the price of the two-phase amortisation."""
    seen: set = set()
    total = 0

    def walk(o):
        nonlocal total
        if isinstance(o, np.ndarray):
            if id(o) not in seen:
                seen.add(id(o))
                total += o.nbytes
        elif isinstance(o, dict):
            for v in o.values():
                walk(v)
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)

    walk(getattr(cache, "levels", []))
    walk(getattr(cache, "a0_pat", None))
    return total


def _i32(a):
    """A value map as int32 where it fits (it indexes arrays < 2³¹), else
    int64: halves the cache at large sizes."""
    a = np.asarray(a)
    if a.size and int(a.max()) >= (1 << 31):
        return np.ascontiguousarray(a, np.int64)
    return np.ascontiguousarray(a, np.int32)


def _pat(indptr, indices, n_cols):
    """Contiguous (indptr int64, indices int32, n_cols) pattern triple."""
    return (np.ascontiguousarray(indptr, np.int64),
            np.ascontiguousarray(indices, np.int32), int(n_cols))


def _csr_of(pat, data):
    import scipy.sparse as sp

    indptr, indices, n_cols = pat
    m = sp.csr_matrix((data, indices, indptr),
                      shape=(len(indptr) - 1, n_cols))
    m.has_sorted_indices = True   # cached patterns are canonical
    return m


def _ell_pos(indptr, k):
    """Flat (row·k + slot) position of each CSR entry in its ELL plane."""
    lengths = np.diff(indptr)
    pos = np.arange(indptr[-1], dtype=np.int64) - np.repeat(
        np.asarray(indptr[:-1], np.int64), lengths)
    rows = np.repeat(np.arange(len(lengths), dtype=np.int64), lengths)
    return pos + rows * k


class SetupCache:
    """Symbolic record of a host PMIS setup (``amg_setup(cache=)``)."""

    def __init__(self):
        self.levels: List[dict] = []
        self.hier = None
        self.params: Optional[AMGParams] = None
        self.l0_dia = False      # the fine operator was a Dia (its planes
                                 # keep DIA layout in strength and interp)
        self.dia_shape = None    # (offsets, n_rows) of that Dia
        self.a0_pat = None       # the fine operator's CSR pattern

    def start(self, a, a_sp) -> None:
        """Begin recording a setup of ``a`` (``a_sp``: its sorted f64 CSR)."""
        self.levels = []
        self.hier = None
        self.l0_dia = isinstance(a, Dia)
        self.dia_shape = ((tuple(int(o) for o in a.offsets), a.n_rows)
                          if self.l0_dia else None)
        self.a0_pat = (np.array(a_sp.indptr, np.int64),
                       np.array(a_sp.indices, np.int32), int(a_sp.shape[1]))

    def record_level(self, *, mask, state, cmap, nc, p_col, p_val, p_sp,
                     ac_sp, patterns) -> None:
        """One level's symbolic decisions: strength mask, C/F state, coarse
        map, P's ELL pattern, A_c's pattern, the structural A·P and
        Pᵀ(A·P) patterns and the P → Pᵀ value permutation."""
        import scipy.sparse as sp

        lc = dict(mask=mask, state=state, cmap=cmap, nc=nc,
                  p_col=p_col.copy(), p_valid=p_val != 0,
                  ac_indptr=ac_sp.indptr.copy(),
                  ac_indices=ac_sp.indices.copy())
        lc.update({k + "_pat": v for k, v in patterns.items()})
        tag = sp.csr_matrix((np.arange(p_sp.nnz, dtype=np.int64),
                             p_sp.indices, p_sp.indptr), shape=p_sp.shape)
        lc["pt_perm"] = tag.T.tocsr().data.copy()
        self.levels.append(lc)

    def finish(self, hier, params) -> None:
        self.hier = hier
        self.params = params


class StructuredLevel(NamedTuple):
    """One level of a structured setup, as a refresh reuses it."""
    axes: Tuple[bool, ...]          # the axes coarsened from the level
    coarse_dims: Tuple[int, ...]    # the next level's grid
    p: object                       # its GridProlong
    r: object                       # its GridRestrict


class StructuredCache:
    """Record of a structured setup (``amg_setup(..., grid=, cache=)``, either
    flavor), for :func:`structured_refresh`."""

    def __init__(self):
        self.dims = None        # the fine grid
        self.offsets = None     # the fine operator's plane offsets
        self.params: Optional[AMGParams] = None
        self.steps = None       # the flavor's steps (``_StructuredSteps``)
        self.levels: List[StructuredLevel] = []
        self.planes = []        # per level of the newest hierarchy: its
                                # offsets, and its Galerkin product's
        self.hier = None        # the newest hierarchy
        self.graphs = None      # the refresh's CUDA graphs (RefreshGraphs)
        self.graph_refreshes = 0    # refreshes the graphs gave

    def start(self, dims, offsets, params, steps) -> None:
        self.dims = tuple(int(d) for d in dims)
        self.offsets = tuple(int(o) for o in offsets)
        self.params, self.steps = params, steps
        self.levels, self.planes = [], []
        self.hier = self.graphs = None

    def record_level(self, axes, coarse_dims, p, r) -> None:
        self.levels.append(StructuredLevel(tuple(axes), tuple(coarse_dims),
                                           p, r))

    def check(self, a, offsets, n: int) -> None:
        """Raise :class:`PatternChangedError` unless the operator ``a`` (its
        plane ``offsets``, ``n`` rows on the cached grid) has the recorded
        fine grid and offsets."""
        dims = getattr(a, "dims", None)
        rows = a.n_rows if isinstance(a, Dia) else a.shape[0]
        if rows != n or (dims is not None
                         and tuple(int(d) for d in dims) != self.dims):
            raise PatternChangedError(f"L0: grid changed ({rows} rows, dims "
                                      f"{dims}; cached {self.dims})")
        if tuple(int(o) for o in offsets) != self.offsets:
            raise PatternChangedError("L0: DIA offsets changed")


def structured_refresh(a_new, cache: StructuredCache):
    """The structured hierarchy of ``a_new``, an operator on the cached grid
    with the cached fine offsets, with the cached grids, axes and
    transfers kept.

    Runs the setup's own level loop (``_amg_setup_structured``) pinned to
    the cached levels: per level the Galerkin planes, dinv (the centre
    plane, or the l1 sums), λmax, the level's form (``ConstDia``, or
    ``Dia`` bf16 if lossless) and, last, the coarse factor, with the
    setup's own step functions and labels (``OMP_AMG_SETUP_TIMERS=1``). So
    the result is bitwise a fresh setup of ``a_new`` run with the cached
    axes. Returns a new ``Hierarchy`` on the cached one's device; the
    cached one's tensors are not written.

    On a CUDA device (the device flavor) the loop's device work is then
    held in CUDA graphs (:class:`RefreshGraphs`), and the next refreshes
    replay them: the same kernels on the same values, so the same bits,
    with a few launches a level where the loop takes hundreds. A replay
    whose product drops other taps, or whose probe fails, is set aside
    for the loop.

    Why the axes are kept and not chosen anew: on a structured operator the
    axes decide only how fast the grid shrinks. Galerkin operators of an
    SPD operator on any fixed grid hierarchy are SPD, so the V-cycle stays
    a convergent SPD preconditioner (and the f64 certificate judges every
    answer). A value change that moves the stiffness scores (a diagonal
    shift A + s·I) therefore leaves the cached grids valid, unlike a
    cached PMIS C/F split, which a changed strength mask invalidates. A
    coarse level may gain or lose planes (an exact zero coming back): its
    form is rebuilt. Raises :class:`PatternChangedError` where the fine
    dims or offsets differ, or where a level's new planes need more taps
    than its kernel takes (``MAX_TAPS``, ``MAX_DIAG``:
    :class:`FormLimitError`); any other error of the loop is raised as it
    is."""
    from .hierarchy import _amg_setup_structured

    if cache.hier is None:
        raise ValueError("cache was not finished by amg_setup")
    if cache.graphs is not None:
        hier = cache.graphs.refresh(a_new, cache)
        if hier is not None:
            cache.graph_refreshes += 1
            cache.hier = hier
            return hier
    device = cache.hier.device
    hier = _amg_setup_structured(a_new, cache.dims, cache.params, device,
                                 False, cache.steps, pinned=cache)
    if (cache.steps.engine == "comb" and cache.levels
            and torch.device(device).type == "cuda"):
        cache.graphs = RefreshGraphs(a_new, cache)
    return hier


class _GraphLevel(NamedTuple):
    """One level of :class:`RefreshGraphs`: its two graphs, what they were
    captured for, and the static tensors they write."""
    rap: object             # the Galerkin planes and the probe
    lmax: object            # dinv, λmax and the form's checks
    offsets: tuple          # the level's plane offsets
    dims: tuple             # its grid
    keep: tuple             # the product's taps kept (the rest all zero)
    out_offsets: tuple      # the kept taps' offsets
    out: torch.Tensor       # the kept planes: the next level's operator
    amax: torch.Tensor      # max |·| of every tap of the product
    probe: torch.Tensor     # [max|A_c x − R A P x|, max|R A P x|]
    dinv: torch.Tensor
    reads: torch.Tensor     # λmax, bf16-lossless, then [const, coeffs...]


class _Eager:
    """A captured graph's stand-in on CPU tensors: ``replay`` runs ``fn``
    again and copies its tensors into those of the first run (``out``)."""

    def __init__(self, fn):
        self.fn = fn
        self.out = fn()

    def replay(self) -> None:
        for d, v in zip(self.out, self.fn()):
            if isinstance(d, torch.Tensor):
                d.copy_(v)


class RefreshGraphs:
    """The device work of a structured refresh, level by level, as two CUDA
    graphs a level over static planes: ``L<k> RAP`` (the Galerkin planes
    by :func:`.comb_rap.galerkin_planes_device`, every tap's max |·|, the
    taps the newest hierarchy kept, the probe of
    :func:`.comb_rap.probe_device`) and ``L<k> lmax`` (dinv, λmax by
    :func:`.smoothers.lmax_tensor`, and the two checks that decide the
    level's form: :func:`~.sparse.formats.const_check` where the shape
    allows a constant stencil, :func:`~.sparse.formats.bf16_check`), each
    level's reading the planes the level above wrote. Captured after a
    pinned loop (``planes`` of the cache: the taps its products kept),
    into one private pool (the graphs replay in the order of their
    capture, one at a time). On CPU tensors each graph is an eager
    stand-in (:class:`_Eager`), which the tests drive.

    :meth:`refresh` copies the fine planes in, replays every graph, reads
    every max, probe, λmax and check in one copy, and builds the levels
    (their forms, the coarse factor) from clones of the static planes, as
    the loop builds them from its own. The same kernels run on the same
    values: the hierarchy is bitwise the loop's."""

    def __init__(self, a, cache: StructuredCache):
        from ..solvers import graph as G
        from .comb_rap import galerkin_offsets

        device = torch.device(cache.hier.device)
        _, data = cache.steps.planes(a, device)
        self.params = cache.params
        self.inp = data.clone()
        specs, x, dims = [], self.inp, cache.dims
        for lv, (offs, out) in zip(cache.levels, cache.planes):
            full = galerkin_offsets(offs, dims, lv.coarse_dims, lv.axes)
            specs.append((offs, dims, lv,
                          tuple(i for i, o in enumerate(full) if o in out)))
            dims = lv.coarse_dims
        self.levels = []
        if device.type != "cuda":
            x = self.inp
            for spec in specs:
                rap = _Eager(lambda spec=spec, x=x: self._rap(spec, x))
                lmax = _Eager(lambda spec=spec, x=x: self._lmax(spec, x))
                x = self._level(spec, rap, lmax, rap.out, lmax.out)
            return
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        c0 = G.counts()
        self.stream.wait_stream(torch.cuda.current_stream(device))
        # a warm-up on the capture stream: the cuBLAS workspace and every
        # host-side cache (the axis weights, the tap boxes)
        with torch.cuda.stream(self.stream):
            x = self.inp
            for spec in specs:
                self._lmax(spec, x)
                x = self._rap(spec, x)[1]
        torch.cuda.synchronize(device)
        x, got = self.inp, {}
        with G.no_gc():
            for spec in specs:
                rap, lmax = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
                G.capture_into(rap, self.pool, self.stream,
                               lambda: got.update(rap=self._rap(spec, x)))
                G.capture_into(lmax, self.pool, self.stream,
                               lambda: got.update(lmax=self._lmax(spec, x)))
                x = self._level(spec, rap, lmax, got["rap"], got["lmax"])
        G.restore(c0)

    def _level(self, spec, rap, lmax, rap_out, lmax_out) -> torch.Tensor:
        offs, dims, _, keep = spec
        out_offsets, out, amax, probe = rap_out
        self.levels.append(_GraphLevel(rap, lmax, tuple(offs), tuple(dims),
                                       keep, tuple(out_offsets), out, amax,
                                       probe, *lmax_out))
        return out

    def _rap(self, spec, x):
        from .comb_rap import galerkin_planes_device, probe_device, select_taps

        offs, dims, lv, keep = spec
        full_offs, full = galerkin_planes_device(offs, x, dims,
                                                 lv.coarse_dims, lv.axes)
        amax = full.abs().amax(dim=1)
        out_offsets, out = select_taps(full_offs, full, list(keep))
        return (out_offsets, out, amax,
                probe_device(offs, x, dims, lv.coarse_dims, lv.axes,
                             out_offsets, out))

    def _lmax(self, spec, x):
        from ..sparse.formats import bf16_check, const_check, const_shape
        from .hierarchy import _level_dinv
        from .smoothers import lmax_tensor

        offs, dims, _, _ = spec
        cur = Dia(data=x, offsets=tuple(offs), dims=dims)
        dinv = _level_dinv(offs, x, self.params)
        reads = [lmax_tensor(cur, dinv).reshape(1),
                 bf16_check(x).reshape(1).float()]
        shape = (const_shape(cur) if self.params.const_stencil != "off"
                 else None)
        if shape is not None:
            col, ok = const_check(x, shape)
            reads += [ok.reshape(1).float(), col]
        return dinv, torch.cat(reads)

    def refresh(self, a, cache: StructuredCache):
        """The refreshed hierarchy of ``a``, or None where a product kept
        other taps or a probe failed (the loop then decides). Raises
        :class:`PatternChangedError` as the loop does."""
        from .comb_rap import probe_passes
        from .hierarchy import _structured_coarse, _structured_level

        device = cache.hier.device
        offsets, data = cache.steps.planes(a, device)
        cache.check(a, offsets, int(np.prod(cache.dims)))
        trace = SetupTrace()
        self.inp.copy_(data)
        for k, lv in enumerate(self.levels):
            with trace.phase(f"L{k} RAP") as ph:
                lv.rap.replay()
                ph.sync = lv.out
            with trace.phase(f"L{k} lmax") as ph:
                lv.lmax.replay()
                ph.sync = lv.reads
        vals = torch.cat([t.reshape(-1) for lv in self.levels
                          for t in (lv.amax, lv.probe, lv.reads)]).tolist()
        found, i = [], 0
        for lv in self.levels:
            m, r = len(lv.amax), len(lv.reads)
            amax, (err, scale) = vals[i:i + m], vals[i + m:i + m + 2]
            reads = vals[i + m + 2:i + m + 2 + r]
            i += m + 2 + r
            if (tuple(j for j, v in enumerate(amax) if v > 0) != lv.keep
                    or not probe_passes(err, scale)):
                return None
            const = ((tuple(reads[3:]), reads[2] != 0) if r > 2 else None)
            found.append((reads[0], (const, reads[1] != 0)))
        levels = []
        for k, (lv, clv) in enumerate(zip(self.levels, cache.levels)):
            # the static planes are written by the next replay: clones
            planes = data if k == 0 else self.levels[k - 1].out.clone()
            cur = Dia(data=planes, offsets=lv.offsets, dims=lv.dims)
            lmax, checked = found[k]
            levels.append(_structured_level(trace, k, cur, lv.dinv.clone(),
                                            lmax, clv.p, clv.r, cache.params,
                                            device, checked))
        last = self.levels[-1]
        return _structured_coarse(trace, levels, last.out_offsets, last.out,
                                  cache.levels[-1].coarse_dims, cache.params,
                                  device, cache.steps.engine, True)


def _build_level_num(c, a_pat, host_dia0):
    """Freeze the level's numeric dataflow (cold refresh, once)."""
    from .. import native
    from ..native import csr_flat_keys
    from ..sparse.formats import dia_to_scipy

    num: dict = {"a_pat": a_pat}
    indptr, indices, _ = a_pat
    nnz = int(indptr[-1])
    n = len(indptr) - 1

    if host_dia0 is not None:
        # DIA flat → CSR order selection: tag the nonzero entries (the DIA
        # → CSR conversion drops zeros; the contract keeps the nonzero set)
        flat = host_dia0.data.ravel()
        base = np.flatnonzero(flat)
        tags = np.zeros_like(flat)
        tags[base] = base + 1.0
        tag_csr = dia_to_scipy(Dia(data=tags.reshape(host_dia0.data.shape),
                                   offsets=host_dia0.offsets,
                                   dims=host_dia0.dims))
        if tag_csr.nnz != nnz:
            raise PatternChangedError("L0: DIA nonzero set changed")
        num["dia_sel"] = _i32(tag_csr.data.astype(np.int64) - 1)
        num["dia_size"] = flat.size
    else:
        # CSR → ELL value positions and the column planes (strength and
        # interpolation run on ELL planes); a Dia level keeps DIA layout
        k = int(c["mask"].shape[1])
        num["ell_pos"] = _i32(_ell_pos(indptr, k))
        col = np.zeros((n, k), np.int32)
        col.ravel()[num["ell_pos"]] = indices
        num["col_planes"] = col

    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    dpos = np.flatnonzero(indices.astype(np.int64) == rows)
    num["diag_pos"] = dpos if len(dpos) == n else None

    # P: ELL → CSR value positions (valid slots in row/column order) and
    # its CSR pattern, both from the cached planes, as the setup built P
    p_valid = c["p_valid"]
    nc = int(c["nc"])
    valid_flat = np.flatnonzero(p_valid.ravel())
    v_rows = valid_flat // p_valid.shape[1]
    v_cols = c["p_col"].ravel()[valid_flat].astype(np.int64)
    order = np.argsort(v_rows * nc + v_cols, kind="stable")
    num["p_pos"] = _i32(valid_flat[order])
    p_indptr = np.zeros(p_valid.shape[0] + 1, np.int64)
    np.cumsum(p_valid.sum(axis=1), out=p_indptr[1:])
    num["p_pat"] = _pat(p_indptr, v_cols[order], nc)
    if len(c["pt_perm"]) != len(valid_flat):
        raise PatternChangedError("P's cached transpose permutation does "
                                  "not match its pattern")
    pt_sp = _csr_of(num["p_pat"], np.ones(len(valid_flat))).T.tocsr()
    pt_sp.sort_indices()
    num["pt_pat"] = _pat(pt_sp.indptr, pt_sp.indices, pt_sp.shape[1])
    num["pt_perm"] = _i32(c["pt_perm"])

    # Galerkin patterns: the structural A·P and Pᵀ(A·P) the setup recorded
    # (the native product keeps exact-zero products); A_c's eliminated
    # them, so map structural → kept positions
    if "ap_pat" in c and "acs_pat" in c:
        num["ap_pat"] = _pat(*c["ap_pat"])
        num["acs_pat"] = _pat(*c["acs_pat"])
    else:   # a setup without the native library: derive them (ones)
        ap = native.spgemm(_csr_of(a_pat, np.ones(nnz)),
                           _csr_of(num["p_pat"], np.ones(len(valid_flat))))
        ap.sort_indices()
        acs = native.spgemm(pt_sp, ap)
        acs.sort_indices()
        num["ap_pat"] = _pat(ap.indptr, ap.indices, ap.shape[1])
        num["acs_pat"] = _pat(acs.indptr, acs.indices, acs.shape[1])
    acs_indptr, acs_indices, ncc = num["acs_pat"]
    acs_keys = csr_flat_keys(acs_indptr, acs_indices, ncc)
    ac_keys = csr_flat_keys(c["ac_indptr"], c["ac_indices"], ncc)
    keep = np.searchsorted(acs_keys, ac_keys)
    if (keep >= len(acs_keys)).any() or not np.array_equal(
            acs_keys[np.minimum(keep, len(acs_keys) - 1)], ac_keys):
        raise PatternChangedError("Galerkin structural pattern mismatch")
    num["keep"] = _i32(keep)
    dropped = np.ones(len(acs_keys), bool)
    dropped[keep] = False
    num["dropped"] = _i32(np.flatnonzero(dropped))
    num["ac_pat"] = _pat(c["ac_indptr"], c["ac_indices"], nc)
    return num


def _rap_numeric(num, a_data, p_data):
    """A_c's values on the cached pattern: numeric-only Pᵀ·(A·P)."""
    from .. import native

    ap_val = native.spgemm_numeric(num["a_pat"], a_data, num["p_pat"],
                                   p_data, num["ap_pat"])
    pt_val = native.perm_gather(num["pt_perm"], p_data)
    acs_val = native.spgemm_numeric(num["pt_pat"], pt_val, num["ap_pat"],
                                    ap_val, num["acs_pat"])
    dropped = num["dropped"]
    if len(dropped):
        # the interpolation values pass through f32 planes, so a non-dyadic
        # value change leaves f32 residue (~1e-8 of the scale) on entries
        # that cancelled exactly at setup; more is a pattern change
        scale = np.abs(acs_val).max() if len(acs_val) else 1.0
        if np.abs(acs_val[dropped]).max() > DROPPED_TOL * max(scale, 1e-300):
            raise PatternChangedError(
                "Galerkin entry eliminated at setup became nonzero")
    return native.perm_gather(num["keep"], acs_val)


def _refill(old: Csr, data: np.ndarray, what: str) -> Csr:
    """``old`` with new values in its CSR order, rounded f64 → f32 (→ its
    value type) as ``csr_from_scipy`` rounds them, and one host → device
    copy; the index tensors are ``old``'s."""
    if len(data) != old.nnz:
        raise PatternChangedError(f"{what}: nnz changed ({len(data)} vs "
                                  f"{old.nnz})")
    vals = torch.from_numpy(np.ascontiguousarray(data, np.float32))
    return dataclasses.replace(old, vals=vals.to(old.vals.dtype).to(
        old.vals.device))


def _host_dia(a: Dia) -> Dia:
    return Dia(data=np.ascontiguousarray(_numpy(a.data), np.float64),
               offsets=tuple(int(o) for o in a.offsets), dims=a.dims)


def canonical_csr(a):
    """scipy CSR (f64) of ``a`` in the order the refresh writes values in:
    sorted rows, duplicates summed, no stored zeros (``a``'s own arrays
    when it is already so). A value that becomes exactly zero then changes
    the pattern, as a Dia entry does."""
    import scipy.sparse as sp

    m = sp.csr_matrix(a, dtype=np.float64)
    if not m.has_canonical_format or not m.data.all():
        m = m.copy()
        m.sum_duplicates()
        m.eliminate_zeros()
    return m


def _check_pattern(a_sp, pat, what: str) -> None:
    """Raise unless ``a_sp`` has exactly the pattern ``pat``: the shape,
    the column indices and the row boundaries (identical indices with a
    moved ``indptr`` would otherwise pass and mis-apply values)."""
    ip, ix, ncl = pat
    if (a_sp.shape != (len(ip) - 1, ncl) or a_sp.nnz != len(ix)
            or not np.array_equal(a_sp.indices, ix)
            or not np.array_equal(a_sp.indptr, ip)):
        raise PatternChangedError(f"{what}: CSR pattern changed")


def amg_refresh(a_new, cache: SetupCache, *, verify_mask: bool = True):
    """Rebuild the cached hierarchy's values for a same-sparsity operator.

    ``a_new``: a ``Dia`` with the cached fine operator's offsets and size,
    or a scipy matrix with its CSR pattern. Returns a new ``Hierarchy`` on
    the cached one's device whose index tensors are the cached ones.
    ``verify_mask=True`` recomputes each level's strength mask and compares
    it with the cache; the interpolation and Galerkin guards are always
    on. Raises :class:`PatternChangedError` when the values change a
    symbolic decision.
    """
    from .. import native
    from ..sparse.formats import (
        dia_to_scipy, ell_planes_from_dia, ell_planes_from_scipy,
    )
    from ..utils.memtune import tune_malloc
    from . import host_setup as hs
    from .hierarchy import (
        Hierarchy, _coarse_factor, _estimate_lmax_host,
        fine_operator, make_level, rap_products,
    )

    tune_malloc()
    trace = SetupTrace()
    if cache.hier is None:
        raise ValueError("cache was not finished by amg_setup")
    params = cache.params
    old_hier = cache.hier
    device = old_hier.device

    cold = any("num" not in c for c in cache.levels)
    host_dia0 = None
    a_sp = None
    if isinstance(a_new, Dia):
        if not cache.l0_dia:
            raise PatternChangedError("L0: the cached setup's fine operator "
                                      "is a CSR matrix, not a Dia")
        host_dia0 = _host_dia(a_new)
        if (host_dia0.offsets, host_dia0.n_rows) != cache.dia_shape:
            raise PatternChangedError("L0: DIA offsets or size changed")
        if cold or not cache.levels:
            a_sp = dia_to_scipy(host_dia0)
            _check_pattern(a_sp, cache.a0_pat, "L0")
    else:
        if cache.l0_dia:
            raise PatternChangedError("L0: cached Dia operator without Dia "
                                      "input")
        a_sp = canonical_csr(a_new)
        _check_pattern(a_sp, cache.a0_pat, "L0")

    levels = []
    a_data = (np.ascontiguousarray(a_sp.data, np.float64)
              if a_sp is not None else None)
    a_pat = cache.a0_pat
    for li, c in enumerate(cache.levels):
        with trace.phase(f"L{li} planes"):
            old = old_hier.levels[li]
            mask, state, cmap, nc = c["mask"], c["state"], c["cmap"], c["nc"]
            num = c.get("num")
            l0_dia = li == 0 and host_dia0 is not None
            if num is None:
                # cold: planes from the CSR values; the dataflow is frozen
                # below
                if l0_dia:
                    # the setup computed L0's mask and interpolation on DIA
                    # layout planes (slot = diagonal); CSR-compacted planes
                    # put the entries at other slots and would trip the
                    # guards
                    col, val, _ = ell_planes_from_dia(host_dia0,
                                                      dtype=np.float32)
                else:
                    col, val = ell_planes_from_scipy(_csr_of(a_pat, a_data),
                                                     dtype=np.float32)[:2]
                if col.shape != mask.shape:
                    raise PatternChangedError(f"L{li}: ELL width changed")
            else:
                if l0_dia:
                    flat = host_dia0.data.ravel()
                    if flat.size != num["dia_size"]:
                        raise PatternChangedError("L0: DIA shape changed")
                    a_data = native.perm_gather(num["dia_sel"], flat)
                    if len(a_data) and (a_data == 0).any():
                        raise PatternChangedError(
                            "L0: a stored DIA entry became exactly zero")
                    if np.count_nonzero(flat) != len(a_data):
                        raise PatternChangedError(
                            "L0: DIA nonzero set changed")
                    col, val, _ = ell_planes_from_dia(host_dia0,
                                                      dtype=np.float32)
                else:
                    col = num["col_planes"]
                    val = np.zeros(col.shape, np.float32)
                    val.ravel()[num["ell_pos"]] = a_data
        with trace.phase(f"L{li} strength-verify"):
            if verify_mask:
                m2 = hs.strength_mask_host(col, val, params.theta)
                if not np.array_equal(m2, mask):
                    raise PatternChangedError(f"L{li}: strength mask changed")
        with trace.phase(f"L{li} interp"):
            if params.interp == "standard":
                p_col, p_val = hs.standard_interpolation_np(
                    col, val, mask, state, cmap, nc,
                    max_elements=params.interp_max_elements)
            elif params.interp == "extpi":
                p_col, p_val = hs.extpi_interpolation(
                    col, val, mask, state, cmap, nc,
                    max_elements=params.interp_max_elements)
            else:
                p_col, p_val = hs.direct_interpolation_np(col, val, mask,
                                                          state, cmap, nc)
            if not np.array_equal(p_col, c["p_col"]):
                if params.interp != "extpi":
                    raise PatternChangedError(f"L{li}: interpolation pattern "
                                              "changed")
                # near-tie truncation flips: recompute just those rows with
                # the selection pinned to the cached pattern (the contract
                # is "cached pattern, new values")
                bad = np.flatnonzero((p_col != c["p_col"]).any(axis=1)
                                     | ((p_val != 0) != c["p_valid"]).any(
                                         axis=1))
                try:
                    pv_rows = hs.extpi_pinned_rows(
                        col, val, mask, state, cmap, nc, bad, c["p_col"],
                        c["p_valid"])
                except ValueError as e:
                    raise PatternChangedError(f"L{li}: {e}") from e
                p_val = p_val.copy()
                p_val[bad] = pv_rows
                p_val[~c["p_valid"]] = 0
        with trace.phase(f"L{li} RAP"):
            if num is None:
                num = _build_level_num(c, a_pat,
                                       host_dia0 if li == 0 else None)
                c["num"] = num
            p_data = np.ascontiguousarray(p_val.ravel()[num["p_pos"]],
                                          np.float64)
            ac_data = _rap_numeric(num, a_data, p_data)

        with trace.phase(f"L{li} lmax/dinv"):
            a_csr = _csr_of(num["a_pat"], a_data)
            if params.smoother == "l1jacobi":
                dinv = 1.0 / np.asarray(np.abs(a_csr).sum(axis=1)).ravel()
            elif num["diag_pos"] is not None:
                dinv = 1.0 / a_data[num["diag_pos"]]
            else:
                dinv = 1.0 / a_csr.diagonal()
            lmax = _estimate_lmax_host(a_csr, dinv)

        with trace.phase(f"L{li} streams"):
            if c["a_kind"] == "Dia":
                if not l0_dia:
                    raise PatternChangedError(f"L{li}: cached Dia operator "
                                              "without Dia input")
                a_lvl = fine_operator(host_dia0, device)
            else:
                a_lvl = _refill(old.a, a_data, f"L{li} A")
            p_lvl = _refill(old.p, p_data, f"L{li} P")
            if "pt_perm_dev" not in num:
                num["pt_perm_dev"] = torch.from_numpy(
                    num["pt_perm"].astype(np.int64)).to(device)
            if old.r.nnz != len(num["pt_perm"]) or \
                    old.r.vals.dtype != p_lvl.vals.dtype:
                raise PatternChangedError(f"L{li}: R no longer Pᵀ's pattern")
            r_lvl = dataclasses.replace(
                old.r, vals=p_lvl.vals.index_select(0, num["pt_perm_dev"]))
            levels.append(make_level(a_lvl, dinv, lmax, p_lvl, r_lvl, params,
                                     device))
        a_data, a_pat = ac_data, num["ac_pat"]

    with trace.phase("coarse planes"):
        pass    # the loop made them (the reference's phase)
    with trace.phase("coarse factor"):
        dense = np.asarray(_csr_of(a_pat, a_data).toarray(), np.float64)
        fac = _coarse_factor(dense, params)
    with trace.phase("pack+upload") as ph:
        coarse_chol = torch.from_numpy(fac.astype(np.float32)).to(device)
        ph.sync = coarse_chol
    # the values of every product come from the host, rap="probe" or not
    engines = ("host",) * len(levels)
    rap_products.update(engines)
    hier = Hierarchy(levels=tuple(levels), coarse_chol=coarse_chol,
                     params=params, rap_engines=engines)
    cache.hier = hier
    return hier
