"""The port's per-shard structured setup against the reference's, on the
CPU (the reference's on a 4-device virtual CPU mesh):

- ``dist_structured_setup`` at d = 4 on the 7-point 16³, 27-point 16³ and
  anisotropic 9-point 32² configurations: the same levels, sharded flags and
  offsets; every level's values within 1e-6 of the largest (both f32 chains
  of the same order on the sharded levels; the same host setup on the
  agglomerated tail); λmax within 1e-5 relative;
- the port's per-level arrays (values and ``dinv``) bit-identical between
  d = 2 and d = 8, the reference's determinism contract.
"""

import jax
import numpy as np
import pytest
import torch

import omp_amg_tpu as ref
from omp_amg_tpu.amg.params import AMGParams as RefParams
from omp_amg_tpu.parallel.dist import AXIS
from omp_amg_tpu.parallel.dist_setup import (
    dist_structured_setup as ref_dist_setup,
)
from omp_amg_tpu.parallel.slab import SlabDia as RefSlabDia
from omp_amg_tpu.sparse.formats import (
    ConstDia as RefConstDia, PlaneDia, const_to_dia, plane_to_dia,
)

import omp_amg_tpu_torch as port
from omp_amg_tpu_torch.parallel.dist_setup import dist_structured_setup
from omp_amg_tpu_torch.parallel.slab import SlabDia
from omp_amg_tpu_torch.sparse.formats import ConstDia

torch.set_num_threads(2)


def _ref_values(lv):
    a = lv.a
    if isinstance(a, RefConstDia):
        a = const_to_dia(a)
    if isinstance(a, PlaneDia):
        a = plane_to_dia(a)
    return tuple(a.offsets), np.asarray(a.data, np.float64)


def _port_values(lv):
    a = lv.a
    if isinstance(a, SlabDia):
        return a.offsets, torch.cat(a.data, dim=1).double().numpy()
    assert not isinstance(a, ConstDia)
    return tuple(a.offsets), a.data.double().numpy()


@pytest.mark.parametrize("maker,n,grid", [
    ("poisson3d_7pt", 16, (16, 16, 16)),
    ("poisson3d_27pt", 16, (16, 16, 16)),
    ("aniso2d_9pt", 32, (32, 32)),
])
def test_dist_setup_matches_reference(maker, n, grid):
    a_j = getattr(ref, maker)(n)
    dh_j = ref_dist_setup(a_j, grid, jax.make_mesh((4,), (AXIS,)),
                          RefParams(coarse_size=60), agg_rows_per_dev=32)
    dh = dist_structured_setup(getattr(port, maker)(n), grid,
                               port.ShardMesh(4, "cpu"),
                               port.AMGParams(coarse_size=60),
                               agg_rows_per_dev=32)
    assert len(dh.levels) == len(dh_j.levels)
    assert isinstance(dh_j.levels[0].a, RefSlabDia)
    assert [lv.sharded for lv in dh.levels] == [lv.sharded
                                               for lv in dh_j.levels]
    assert dh.coarse_chol.shape == dh_j.coarse_chol.shape
    for l, (lv, lv_j) in enumerate(zip(dh.levels, dh_j.levels)):
        offs, vals = _port_values(lv)
        offs_j, vals_j = _ref_values(lv_j)
        assert offs == offs_j, l
        err = np.abs(vals - vals_j).max()
        assert err <= 1e-6 * np.abs(vals_j).max(), (l, err)
        lmax_j = float(lv_j.lmax)
        assert abs(lv.lmax - lmax_j) <= 1e-5 * abs(lmax_j), l


def test_dist_setup_bitwise_deterministic_across_shard_counts():
    a = port.poisson3d_7pt(16)
    arrays = {}
    for d in (2, 8):
        dh = dist_structured_setup(a, (16, 16, 16), port.ShardMesh(d, "cpu"),
                                   port.AMGParams(coarse_size=60),
                                   agg_rows_per_dev=16)
        arrays[d] = [(torch.cat(lv.a.data, dim=1), torch.cat(lv.dinv))
                     for lv in dh.levels if lv.sharded]
    assert len(arrays[8]) >= 1 and len(arrays[2]) >= 2
    for (v2, i2), (v8, i8) in zip(arrays[2], arrays[8]):
        assert torch.equal(v2, v8) and torch.equal(i2, i8)
