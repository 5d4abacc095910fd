"""The port's z-slab operators against the reference's, on the CPU (the
reference under ``shard_map`` on the 8 virtual CPU devices):

- ``slab_spmv`` at d ∈ {1, 2, 4, 8} on the 7-point 16³, 27-point 8³ and
  5-point 24² operators: max|Δ| ≤ 1e-6·max|y| (the same f32 terms in the
  same order; only FMA contraction may differ);
- the ``remote`` and ``ppermute`` transports bitwise equal, and the thin-slab
  fallback (a halo wider than a slab) against the global product;
- the slab grid transfers, the ``slice_in``/``gather_out`` transitions
  included, within 1e-6;
- the ``dia_spmv`` twin's x window: bitwise its old form at ``x_base = 0``,
  and a window read equal to the product over the matching slice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import omp_amg_tpu as ref
from omp_amg_tpu.parallel.dist import AXIS, dist_spmv as ref_dist_spmv
from omp_amg_tpu.parallel.slab import (
    SlabDia as RefSlabDia, SlabProlong as RefSlabProlong,
    SlabRestrict as RefSlabRestrict,
)

from omp_amg_tpu_torch.ops import dia_spmv
from omp_amg_tpu_torch.parallel.slab import (
    SlabDia, SlabProlong, SlabRestrict, slab_halos, slab_prolong,
    slab_restrict, slab_spmv, slab_windows,
)
from omp_amg_tpu_torch.sparse.formats import Dia

torch.set_num_threads(2)

OPERATORS = [("poisson3d_7pt", 16), ("poisson3d_27pt", 8),
             ("poisson2d_5pt", 24)]


def _mesh(d):
    return jax.make_mesh((d,), (AXIS,))


def _port_slab(a, d, transport="ppermute"):
    data = torch.from_numpy(np.array(a.data, np.float32))
    hl, hr = slab_halos(a.offsets, a.dims)
    return SlabDia(data=tuple(c.contiguous() for c in data.chunk(d, dim=1)),
                   offsets=tuple(a.offsets), dims=tuple(a.dims), hl=hl,
                   hr=hr, transport=transport)


def _x(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("maker,n", OPERATORS)
def test_slab_spmv_matches_reference(d, maker, n):
    a = getattr(ref, maker)(n)
    hl, hr = slab_halos(a.offsets, a.dims)
    op_j = RefSlabDia(data=jnp.asarray(a.data), offsets=a.offsets,
                      dims=a.dims, hl=hl, hr=hr)
    x = _x(a.n_rows)
    f = jax.jit(jax.shard_map(
        ref_dist_spmv, mesh=_mesh(d),
        in_specs=(RefSlabDia(data=P(None, AXIS), offsets=op_j.offsets,
                             dims=op_j.dims, hl=hl, hr=hr), P(AXIS)),
        out_specs=P(AXIS)))
    want = np.asarray(f(op_j, jnp.asarray(x)))
    got = torch.cat(slab_spmv(_port_slab(a, d),
                              list(torch.from_numpy(x).chunk(d)))).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("maker,n", OPERATORS)
def test_transports_bitwise_equal(d, maker, n):
    a = getattr(ref, maker)(n)
    xs = list(torch.from_numpy(_x(a.n_rows, 1)).chunk(d))
    y_pp = slab_spmv(_port_slab(a, d, "ppermute"), xs)
    y_rm = slab_spmv(_port_slab(a, d, "remote"), xs)
    assert all(torch.equal(u, v) for u, v in zip(y_pp, y_rm))


def test_thin_slab_fallback_matches_global():
    # 7-point 4×8×8 on 8 shards: one half-plane per shard, a one-plane halo
    a = ref.poisson3d_7pt(8, 8, 4)
    op = _port_slab(a, 8)
    assert max(op.hl, op.hr) * op.plane > a.n_rows // 8
    x = _x(a.n_rows, 2)
    xs = list(torch.from_numpy(x).chunk(8))
    wins = slab_windows(op, xs, "remote")
    assert [base for _, base in wins] == [i * 32 for i in range(8)]
    assert all(w.numel() == a.n_rows for w, _ in wins)
    got = torch.cat(slab_spmv(op, xs))
    want = ref.dia_to_scipy(a) @ x.astype(np.float64)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def _transfer_case(fs, coarsened):
    cs = tuple((n + 1) // 2 if c else n for n, c in zip(fs, coarsened))
    return dict(fine_shape=fs, coarse_shape=cs, coarsened=coarsened)


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("coarsened", [(True, True, True),
                                       (True, False, True),
                                       (False, True, True)])
def test_slab_transfers_match_reference(d, coarsened):
    shape = _transfer_case((8, 12, 16), coarsened)
    rng = np.random.default_rng(3)
    xc = rng.standard_normal(int(np.prod(shape["coarse_shape"]))).astype(
        np.float32)
    xf = rng.standard_normal(int(np.prod(shape["fine_shape"]))).astype(
        np.float32)
    mesh = _mesh(d)
    for ref_op, op, x in ((RefSlabProlong(**shape), SlabProlong(**shape), xc),
                          (RefSlabRestrict(**shape), SlabRestrict(**shape),
                           xf)):
        f = jax.jit(jax.shard_map(ref_dist_spmv, mesh=mesh,
                                  in_specs=(ref_op, P(AXIS)),
                                  out_specs=P(AXIS)))
        want = np.asarray(f(ref_op, jnp.asarray(x)))
        xs = list(torch.from_numpy(x).chunk(d))
        got = (slab_prolong(op, xs, d) if isinstance(op, SlabProlong)
               else slab_restrict(op, xs))
        got = torch.cat(got).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("coarsened", [(True, True, True),
                                       (False, True, True)])
def test_slab_transitions_match_reference(coarsened):
    d = 4
    shape = _transfer_case((8, 8, 8), coarsened)
    rng = np.random.default_rng(4)
    xc = rng.standard_normal(int(np.prod(shape["coarse_shape"]))).astype(
        np.float32)
    xf = rng.standard_normal(int(np.prod(shape["fine_shape"]))).astype(
        np.float32)
    mesh = _mesh(d)
    sp_j = RefSlabProlong(**shape, slice_in=True)
    sr_j = RefSlabRestrict(**shape, gather_out=True)
    fp = jax.jit(jax.shard_map(ref_dist_spmv, mesh=mesh,
                               in_specs=(sp_j, P(None)), out_specs=P(AXIS)))
    fr = jax.jit(jax.shard_map(ref_dist_spmv, mesh=mesh,
                               in_specs=(sr_j, P(AXIS)), out_specs=P(None)))
    got_p = torch.cat(slab_prolong(SlabProlong(**shape, slice_in=True),
                                   torch.from_numpy(xc), d)).numpy()
    np.testing.assert_allclose(got_p, np.asarray(fp(sp_j, jnp.asarray(xc))),
                               rtol=1e-6, atol=1e-6)
    got_r = slab_restrict(SlabRestrict(**shape, gather_out=True),
                          list(torch.from_numpy(xf).chunk(d)))
    assert isinstance(got_r, torch.Tensor)   # replicated: one full vector
    np.testing.assert_allclose(got_r.numpy(),
                               np.asarray(fr(sr_j, jnp.asarray(xf))),
                               rtol=1e-6, atol=1e-6)


def _old_twin(a, x, mode="spmv", b=None, s=None):
    """``dia_spmv_plain`` before the x window (x of exactly n rows)."""
    n = a.n_rows
    y = torch.zeros(n, dtype=torch.float32)
    lo = max(0, -min(a.offsets))
    hi = max(0, max(a.offsets))
    xp = torch.nn.functional.pad(x, (lo, hi))
    for k, off in enumerate(a.offsets):
        y = y + a.data[k].float() * xp[off + lo: off + lo + n]
    if mode == "residual":
        return b - y
    if mode == "jacobi":
        return x + s * (b - y)
    return y


@pytest.mark.parametrize("mode", ["spmv", "residual", "jacobi"])
def test_dia_window_twin(mode):
    a = ref.poisson3d_27pt(8)
    blk = Dia(data=torch.from_numpy(np.array(a.data, np.float32)),
              offsets=tuple(a.offsets))
    n = a.n_rows
    rng = np.random.default_rng(5)
    x, b, s = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
               for _ in range(3))
    got = dia_spmv.dia_spmv_plain(blk, x, mode, b, s, x_base=0)
    assert torch.equal(got, _old_twin(blk, x, mode, b, s))
    # rows [128, 256) of the product from the window x[64:320] at base 64
    win = Dia(data=blk.data[:, 128:256].contiguous(), offsets=blk.offsets)
    got = dia_spmv.dia_spmv_plain(win, x[64:320], mode, b[128:256],
                                  s[128:256], x_base=64)
    want = _old_twin(blk, x, mode, b, s)[128:256]
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        dia_spmv.spmv(win, x[64:200], x_base=64)
