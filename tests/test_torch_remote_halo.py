"""The port's plane-halo exchange against the reference's, on the CPU:

- ``_exchange_planes_remote`` (the ``remote_halo`` wrapper's twin, then the
  zero mask at the global ends) against the reference's Pallas
  ``_exchange_planes_remote`` run in interpret mode under ``shard_map`` on
  the 8 virtual CPU devices: every shard's window [left halo | rows | right
  halo], exactly (a copy), at d ∈ {2, 4, 8} on the 7-point 16³ and the
  27-point 8³ operators;
- the raw twin's circular contract (the wrap-around strips);
- the wrapper's refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import omp_amg_tpu as ref
from omp_amg_tpu.parallel.slab import (
    AXIS, _exchange_planes_remote as ref_exchange_remote,
    slab_halos as ref_slab_halos,
)

import omp_amg_tpu_torch as port
from omp_amg_tpu_torch.ops.remote_halo import remote_halo, remote_halo_plain
from omp_amg_tpu_torch.parallel.slab import (
    SlabDia, _exchange_planes, _exchange_planes_remote, slab_halos,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("maker,n", [("poisson3d_7pt", 16),
                                     ("poisson3d_27pt", 8)])
def test_exchange_remote_matches_reference(d, maker, n):
    a = getattr(ref, maker)(n)
    hl, hr = ref_slab_halos(a.offsets, a.dims)
    assert (hl, hr) == slab_halos(a.offsets, a.dims) == (1, 1)
    plane = int(np.prod(a.dims[1:]))
    x = np.random.default_rng(0).standard_normal(a.n_rows).astype(np.float32)
    mesh = jax.make_mesh((d,), (AXIS,))
    f = jax.jit(jax.shard_map(
        lambda v: ref_exchange_remote(v, plane, hl, hr), mesh=mesh,
        in_specs=P(AXIS), out_specs=P(AXIS), check_vma=False))
    want = np.asarray(f(jnp.asarray(x)))
    xs = list(torch.from_numpy(x).chunk(d))
    got = torch.cat(_exchange_planes_remote(xs, plane, hl, hr)).numpy()
    assert np.array_equal(got, want)
    # the plain transport gives the same windows
    plain = torch.cat(_exchange_planes(xs, plane, hl, hr)).numpy()
    assert np.array_equal(plain, want)


def test_twin_is_circular():
    rng = np.random.default_rng(1)
    srcs = [torch.from_numpy(rng.standard_normal(10).astype(np.float32))
            for _ in range(3)]
    left, right = remote_halo_plain(srcs, 4, 2)
    for i in range(3):
        assert torch.equal(left[(i + 1) % 3], srcs[i][6:])
        assert torch.equal(right[(i - 1) % 3], srcs[i][:2])
    # shard 0's left halo wraps around from the last shard, the last
    # shard's right halo from shard 0: the caller masks both
    assert torch.equal(left[0], srcs[2][6:])
    assert torch.equal(right[2], srcs[0][:2])
    # on CPU tensors the wrapper is the twin
    got = remote_halo(srcs, 4, 2)
    assert all(torch.equal(u, v) for u, v in zip(got[0], left))
    assert all(torch.equal(u, v) for u, v in zip(got[1], right))


def test_wrapper_refusals():
    srcs = [torch.zeros(8), torch.zeros(8)]
    with pytest.raises(ValueError):
        remote_halo([torch.zeros(8, dtype=torch.float64)] * 2, 2, 2)
    with pytest.raises(ValueError):
        remote_halo([torch.zeros(8), torch.zeros(6)], 2, 2)
    with pytest.raises(ValueError):
        remote_halo(srcs, 9, 0)
    with pytest.raises(ValueError):
        remote_halo([torch.zeros(16)[::2]] * 2, 2, 2)
    with pytest.raises(NotImplementedError):
        remote_halo([torch.zeros(8), torch.zeros(8, device="meta")], 2, 2)
    a = port.poisson3d_7pt(4)
    with pytest.raises(ValueError, match="remote"):
        SlabDia(data=(torch.zeros(7, 64),), offsets=a.offsets, dims=a.dims,
                transport="pallas")
    with pytest.raises(ValueError, match="remote"):
        port.AMGSolver(a, port.AMGParams(), grid=(4, 4, 4),
                       mesh=port.ShardMesh(2, "cpu"), device="cpu",
                       transport="pallas")
