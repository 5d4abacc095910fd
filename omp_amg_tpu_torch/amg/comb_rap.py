"""Galerkin RAP for structured hierarchies, on the host in f64 numpy.

Counterpart of the numpy part of ``omp_amg_tpu/amg/comb_rap.py``. With
linear tensor-product transfers and an operator of per-axis stencil radius
≤ 1, A_c = R A P is again a radius-1 stencil, so it is computed in DIA
layout without any sparse matrix product. :func:`structured_rap` tries, in
this order, each result checked by a random probe ‖A_c x − R A P x‖ before
it is used:

1. the surrogate-grid RAP of a masked-constant stencil (O(1) in grid size);
2. the fused native RAP (``csrc/native.cc`` ``rap_stencil_f64``);
3. the direct stencil convolution in numpy;
4. the lattice-comb probe: responses to the 3^d period-3 combs
   ``v_t[c] = 1 iff c_ax ≡ t_ax (mod 3)`` separate every coarse coupling.

The reference's device RAP engines (``comb_rap_device``, the jitted comb and
per-axis-factored graphs) are not ported here. The comb probe applies its
chain one comb at a time (through the native single-vector transfers when
the library is built) instead of the reference's blocked native pass; the
responses agree to f64 roundoff.
"""

from __future__ import annotations

from itertools import product as iproduct
from typing import Sequence

import numpy as np

from .structured import axis_deltas, grid_strides as _strides


def coarse_offsets(coarse_dims) -> list:
    """Static tap offsets of the comb-assembled coarse operator (sorted):
    every radius-1 delta that fits the coarse grid (the distributed setup's
    coarse DIA layout)."""
    strides = _strides(coarse_dims)
    offs = []
    for delta in iproduct((-1, 0, 1), repeat=len(coarse_dims)):
        if any(abs(dl) >= cd for dl, cd in zip(delta, coarse_dims)):
            continue
        offs.append(sum(dl * st for dl, st in zip(delta, strides)))
    return sorted(offs)


def dia_apply(offsets: Sequence[int], data, x):
    """y = A x for DIA planes (data[k, i] multiplies x[i+off])."""
    n = x.shape[0]
    y = np.zeros_like(x)
    for k, off in enumerate(offsets):
        i0, i1 = max(0, -off), min(n, n - off)
        if i1 > i0:
            y[i0:i1] += data[k, i0:i1] * x[i0 + off:i1 + off]
    return y


def _prolong_axis(x, axis: int, n_f: int):
    nc = x.shape[axis]
    xm = np.moveaxis(x, axis, -1)
    right = np.concatenate([xm[..., 1:], np.zeros_like(xm[..., :1])], axis=-1)
    odd = 0.5 * (xm + right)
    inter = np.stack([xm, odd], axis=-1).reshape(*xm.shape[:-1], 2 * nc)
    return np.moveaxis(inter[..., :n_f], -1, axis)


def _restrict_axis(x, axis: int, nc: int):
    xm = np.moveaxis(x, axis, -1)
    pad = np.zeros_like(xm[..., :1])
    xxp = np.concatenate([pad, xm, pad, pad], axis=-1)
    ext = 2 * nc
    even = xxp[..., 1:1 + ext:2][..., :nc]
    lft = xxp[..., 0:ext:2][..., :nc]
    rgt = xxp[..., 2:2 + ext:2][..., :nc]
    return np.moveaxis(even + 0.5 * (lft + rgt), -1, axis)


def prolong(xc, fine_shape, coarse_shape, coarsened):
    x = xc.reshape(coarse_shape)
    for ax, c in enumerate(coarsened):
        if c:
            x = _prolong_axis(x, ax, fine_shape[ax])
    return x.reshape(-1)


def restrict(xf, fine_shape, coarse_shape, coarsened):
    x = xf.reshape(fine_shape)
    for ax, c in enumerate(coarsened):
        if c:
            x = _restrict_axis(x, ax, coarse_shape[ax])
    return x.reshape(-1)


def comb_rap(offsets: Sequence[int], data, dims: Sequence[int],
             coarse_dims: Sequence[int], coarsened: Sequence[bool],
             validate: bool = True):
    """(offsets_c, data_c) of A_c = R A P in DIA layout by the 3^d comb
    probes. f64 recommended. Raises ValueError when the probe shows the
    radius-1 assumption violated."""
    from .. import native

    d = len(dims)
    nc = int(np.prod(coarse_dims))
    strides_c = _strides(coarse_dims)
    mod3 = np.indices(coarse_dims) % 3
    use_native = native.available()

    def chain(v):
        if use_native:
            return native.restrict(
                native.dia_apply(offsets, data,
                                 native.prolong(v, dims, coarse_dims,
                                                coarsened)),
                dims, coarse_dims, coarsened)
        return restrict(dia_apply(offsets, data,
                                  prolong(v, dims, coarse_dims, coarsened)),
                        dims, coarse_dims, coarsened)

    w = {}
    for t in iproduct(range(3), repeat=d):
        mask = np.ones(coarse_dims, bool)
        for ax in range(d):
            mask &= mod3[ax] == t[ax]
        w[t] = chain(mask.ravel().astype(data.dtype))

    # assemble each coarse diagonal from the responses
    wstack = np.stack([w[t] for t in iproduct(range(3), repeat=d)])
    offsets_c, rows = [], []
    for delta in iproduct((-1, 0, 1), repeat=d):
        if any(abs(dl) >= cd for dl, cd in zip(delta, coarse_dims)):
            continue
        # t index of column i+delta, per coarse row i
        sel = np.zeros(coarse_dims, dtype=np.int64)
        for ax in range(d):
            sel = sel * 3 + (mod3[ax] + delta[ax]) % 3
        offsets_c.append(sum(dl * st for dl, st in zip(delta, strides_c)))
        rows.append(wstack[sel.ravel(), np.arange(nc)])

    # stable: duplicate flat offsets (aliased deltas on tiny coarse grids)
    # must pair rows identically everywhere
    order = np.argsort(offsets_c, kind="stable")
    offsets_c = [offsets_c[i] for i in order]
    data_c = np.stack([rows[i] for i in order])

    if validate:
        rng = np.random.default_rng(0)
        x = rng.standard_normal(nc).astype(np.asarray(data).dtype)
        y2 = chain(x)
        err = float(np.max(np.abs(dia_apply(offsets_c, data_c, x) - y2)))
        scale = float(np.max(np.abs(y2))) + 1e-30
        tol = 1e-8 if data_c.dtype == np.float64 else 2e-4
        if err > tol * scale:
            raise ValueError(f"comb_rap radius assumption violated: {err}")
    keep = [k for k in range(len(offsets_c))
            if float(np.max(np.abs(data_c[k]))) > 0.0]
    offsets_c = [offsets_c[k] for k in keep]
    data_c = np.stack([data_c[k] for k in keep]) if keep else data_c[:0]
    return offsets_c, data_c


def _rap_terms(offsets, dims, coarse_dims, coarsened):
    """Static term table of the direct Galerkin convolution.

    With tensor-product linear transfers, A_c[I, I+δ] = Σ r(s)·r(t)·a_k[u]
    over fine taps k and per-axis stencil positions: u_ax = m·I_ax + s_ax
    (m = 2 on coarsened axes, else 1), t_ax = s_ax + dk_ax − m·δ_ax, with
    r = {0: 1, ±1: ½} on coarsened axes and {0: 1} otherwise. Returns
    ``{delta: [(k, s_vec, weight), ...]}``. Raises ValueError if any tap
    exceeds per-axis radius 1.
    """
    d = len(dims)
    dk_all = axis_deltas(offsets, dims)
    if np.abs(dk_all).max(initial=0) > 1:
        raise ValueError("operator outside the radius-1 structured contract")
    table = {}
    for k in range(len(offsets)):
        axis_combos = []
        for ax in range(d):
            dk = int(dk_all[k, ax])
            if coarsened[ax]:
                combos = []
                for s in (-1, 0, 1):
                    for dlt in (-1, 0, 1):
                        t = s + dk - 2 * dlt
                        if abs(t) <= 1:
                            w = (0.5 if s else 1.0) * (0.5 if t else 1.0)
                            combos.append((s, dlt, w))
            else:
                combos = [(0, dk, 1.0)]
            axis_combos.append(combos)
        for choice in iproduct(*axis_combos):
            delta = tuple(c[1] for c in choice)
            if any(abs(dl) >= cd for dl, cd in zip(delta, coarse_dims)):
                continue
            s_vec = tuple(c[0] for c in choice)
            w = float(np.prod([c[2] for c in choice]))
            table.setdefault(delta, []).append((k, s_vec, w))
    return table


def direct_rap(offsets, data, dims, coarse_dims, coarsened):
    """(offsets_c, data_c) of A_c = R A P by direct stencil convolution:
    each fine diagonal is read O(1) times through strided parity slices.
    Same tap set, stable offset order and masked-zero invariant as
    :func:`comb_rap`; ValueError outside the radius-1 contract."""
    d = len(dims)
    table = _rap_terms(offsets, dims, coarse_dims, coarsened)
    strides_c = _strides(coarse_dims)
    # zero-pad coarsened axes so every (s, parity) slice is exact
    pads = [(1, 1 + 2 * coarse_dims[ax] - dims[ax]) if coarsened[ax]
            else (0, 0) for ax in range(d)]
    grids = {}

    def grid(k):
        if k not in grids:
            g = data[k].reshape(dims)
            if any(p != (0, 0) for p in pads):
                g = np.pad(g, pads)
            grids[k] = g
        return grids[k]

    dtype = data.dtype
    nc = int(np.prod(coarse_dims))
    rows, offs = [], []
    for delta in iproduct((-1, 0, 1), repeat=d):
        if any(abs(dl) >= cd for dl, cd in zip(delta, coarse_dims)):
            continue
        offs.append(sum(dl * st for dl, st in zip(delta, strides_c)))
        terms = table.get(delta)
        if not terms:
            rows.append(np.zeros((nc,), dtype))
            continue
        acc = None
        for k, s_vec, w in terms:
            sl = tuple(
                slice(s + 1, s + 1 + 2 * cdim, 2) if c else slice(None)
                for s, c, cdim in zip(s_vec, coarsened, coarse_dims))
            term = w * grid(k)[sl]
            acc = term if acc is None else acc + term
        # masked-zero invariant: taps whose column I+δ crosses the coarse
        # boundary along any axis must be exact zeros (kernels rely on it)
        for ax, dl in enumerate(delta):
            if dl:
                m = np.ones((coarse_dims[ax],), np.float64)
                m[-1 if dl > 0 else 0] = 0.0
                shape = [1] * d
                shape[ax] = coarse_dims[ax]
                acc = acc * np.asarray(m.reshape(shape), dtype=dtype)
        rows.append(acc.reshape(-1).astype(dtype))
    order = np.argsort(offs, kind="stable")
    return [offs[i] for i in order], np.stack([rows[i] for i in order])


def _balanced_deltas(offsets, dims):
    """Flat offsets → per-axis delta vectors (balanced rounding; valid for
    non-wrapping taps). None if some offset is not decomposable."""
    deltas = axis_deltas(offsets, dims)
    flat = deltas @ np.asarray(_strides(dims), np.int64)
    if not np.array_equal(flat, np.asarray(offsets, np.int64)):
        return None
    return deltas


def _const_stencil_of(offsets, data, dims):
    """(deltas, coeffs) when ``data`` is a masked-constant radius-1 stencil
    on ``dims`` (exact slice-based check), else None."""
    d = len(dims)
    deltas = _balanced_deltas(offsets, dims)
    if deltas is None or np.abs(deltas).max(initial=0) > 1:
        return None
    mid_idx = tuple(dim // 2 for dim in dims)
    if any(not (0 <= mid_idx[ax] + dl < dims[ax])
           for row in deltas for ax, dl in enumerate(row)):
        return None
    mid = 0
    for ax in range(d):
        mid = mid * dims[ax] + mid_idx[ax]
    coeffs = np.asarray(data[:, mid], np.float64)
    for k in range(len(offsets)):
        v = np.asarray(data[k]).reshape(dims)
        box = v[tuple(slice(max(0, -int(dl)), dims[ax] - max(0, int(dl)))
                      for ax, dl in enumerate(deltas[k]))]
        c = v.dtype.type(coeffs[k])
        if not np.all(box == c):
            return None
        if np.count_nonzero(v) != (box.size if c != 0 else 0):
            return None
    return deltas, coeffs


def _const_rap_surrogate(deltas, coeffs, dims, coarse_dims, coarsened):
    """Exact RAP of a masked-constant stencil via a tiny same-parity
    surrogate grid.

    Every coarse value depends only on the per-axis boundary distance of its
    index, clamped at 2, and on the high side on the fine-extent parity. A
    surrogate with matching parity and coarse extent ≥ 5 per axis realizes
    every distance pattern; the full coarse planes are an outer-product
    index-map gather of the surrogate's. The caller's probe stays the
    runtime check.
    """
    d = len(dims)
    dims_s, maps = [], []
    for ax in range(d):
        dim, cdim = int(dims[ax]), int(coarse_dims[ax])
        if coarsened[ax]:
            if cdim != (dim + 1) // 2:
                return None
            fs = 11 if dim % 2 == 1 else 12
        else:
            if cdim != dim:
                return None
            fs = 6 if dim % 2 == 0 else 7
        cs = (fs + 1) // 2 if coarsened[ax] else fs
        if dim <= fs or cdim < 5:
            dims_s.append(dim)
            maps.append(np.arange(cdim, dtype=np.int64))
            continue
        dims_s.append(fs)
        m = np.full(cdim, 2, np.int64)
        m[0], m[1] = 0, 1
        m[-2], m[-1] = cs - 2, cs - 1
        maps.append(m)
    dims_s = tuple(dims_s)
    cdims_s = tuple((ds + 1) // 2 if c else ds
                    for ds, c in zip(dims_s, coarsened))

    # surrogate planes: box-fill of the same (delta, coeff) stencil
    ns = int(np.prod(dims_s))
    strides_s = _strides(dims_s)
    offs_s = [int(sum(dl * st for dl, st in zip(row, strides_s)))
              for row in deltas]
    data_s = np.zeros((len(offs_s), ns), np.float64)
    v3 = data_s.reshape((-1,) + dims_s)
    for k, row in enumerate(deltas):
        v3[(k,) + tuple(slice(max(0, -int(dl)), dims_s[ax] - max(0, int(dl)))
                        for ax, dl in enumerate(row))] = coeffs[k]

    from .. import native

    res = (native.rap_stencil(offs_s, data_s, dims_s, cdims_s, coarsened)
           if native.available() else None)
    if res is None:
        res = comb_rap(offs_s, data_s, dims_s, cdims_s, coarsened)
    offs_cs, data_cs = res

    cdeltas = _balanced_deltas(offs_cs, cdims_s)
    if cdeltas is None or np.abs(cdeltas).max(initial=0) > 1:
        return None
    cstrides = _strides(coarse_dims)
    nc = int(np.prod(coarse_dims))
    offs_c, rows = [], []
    for k, row in enumerate(cdeltas):
        offs_c.append(int(sum(dl * st for dl, st in zip(row, cstrides))))
        s3 = np.asarray(data_cs[k]).reshape(cdims_s)
        rows.append(s3[np.ix_(*maps)].reshape(nc))
    order = np.argsort(offs_c, kind="stable")
    return [offs_c[i] for i in order], np.stack([rows[i] for i in order])


def _probe_ok(offs_c, data_c, offsets, data, dims, coarse_dims, coarsened,
              native_fine: bool, native_coarse: bool = False) -> bool:
    """max|A_c x − R A P x| ≤ 1e-8·max|R A P x| for the seeded probe x.
    ``native_fine``/``native_coarse`` run that side's matvecs through the
    native f64 kernels (the reference's choice per branch)."""
    from .. import native

    x = np.random.default_rng(0).standard_normal(int(np.prod(coarse_dims)))
    if native_coarse:
        y1 = native.dia_apply(offs_c, np.asarray(data_c, np.float64), x)
    else:
        y1 = dia_apply(offs_c, data_c, x)
    if native_fine:
        y2 = native.restrict(
            native.dia_apply(offsets, np.asarray(data, np.float64),
                             native.prolong(x, dims, coarse_dims, coarsened)),
            dims, coarse_dims, coarsened)
    else:
        y2 = restrict(dia_apply(offsets, data,
                                prolong(x, dims, coarse_dims, coarsened)),
                      dims, coarse_dims, coarsened)
    err = float(np.max(np.abs(y1 - y2)))
    return err <= 1e-8 * (float(np.max(np.abs(y2))) + 1e-30)


def _nonzero_taps(offs_c, data_c):
    keep = [k for k in range(len(offs_c))
            if float(np.max(np.abs(data_c[k]))) > 0.0]
    return [offs_c[k] for k in keep], data_c[keep] if keep else data_c[:0]


def structured_rap(offsets, data, dims, coarse_dims, coarsened):
    """Preferred host entry: surrogate-grid RAP for masked-constant
    stencils, then fused native RAP, numpy direct convolution, lattice-comb
    oracle; each result is probe-validated before use."""
    from .. import native

    have_native = native.available()
    cd = _const_stencil_of(offsets, data, dims)
    if cd is not None:
        res = _const_rap_surrogate(cd[0], cd[1], dims, coarse_dims,
                                   coarsened)
        if res is not None and _probe_ok(*res, offsets, data, dims,
                                         coarse_dims, coarsened,
                                         have_native, have_native):
            return _nonzero_taps(*res)
    if have_native:
        res = native.rap_stencil(offsets, data, dims, coarse_dims, coarsened)
        if res is not None and _probe_ok(*res, offsets, data, dims,
                                         coarse_dims, coarsened, True):
            return res
    try:
        res = direct_rap(offsets, data, dims, coarse_dims, coarsened)
        if _probe_ok(*res, offsets, data, dims, coarse_dims, coarsened,
                     False):
            return _nonzero_taps(*res)
    except ValueError:
        pass
    return comb_rap(offsets, data, dims, coarse_dims, coarsened)
