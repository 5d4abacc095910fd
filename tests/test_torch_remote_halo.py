"""The port's halo-window exchange against the reference's, on the CPU:

- ``_exchange_planes_remote`` (one ``remote_halo_window`` call; on CPU
  tensors the wrapper's twin) against the reference's Pallas
  ``_exchange_planes_remote`` run in interpret mode under ``shard_map`` on
  the 8 virtual CPU devices: every shard's window [left halo | rows | right
  halo], exactly (a copy), at d ∈ {2, 4, 8} on the 7-point 16³ and the
  27-point 8³ operators;
- the window twin's contract: the plain exchange's windows, zero at the
  global ends, and the wrapper is the twin on CPU tensors;
- the kernel's path rule;
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
from omp_amg_tpu_torch.ops.remote_halo import (
    remote_halo_window, remote_halo_window_plain, vector_path,
)
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


@pytest.mark.parametrize("nl,nr", [(4, 2), (0, 3), (5, 0)])
@pytest.mark.parametrize("d", [1, 2, 3, 8])
def test_window_twin_contract(d, nl, nr):
    n = 10
    rng = np.random.default_rng(1)
    srcs = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            for _ in range(d)]
    win = remote_halo_window_plain(srcs, nl, nr)
    assert win.shape == (d, nl + n + nr)
    # every window is the plain exchange's (one-row planes: halos of nl, nr)
    for w, want in zip(win, _exchange_planes(srcs, 1, nl, nr)):
        assert torch.equal(w, want)
    # non-circular: zeros beyond the global ends, neighbours' rows inside
    assert not win[0, :nl].any() and not win[d - 1, nl + n:].any()
    for i in range(1, d):
        assert torch.equal(win[i, :nl], srcs[i - 1][n - nl:])
        assert torch.equal(win[i - 1, nl + n:], srcs[i][:nr])
    # on CPU tensors the wrapper is the twin
    assert torch.equal(remote_halo_window(srcs, nl, nr), win)


@pytest.mark.parametrize("n,nl,nr,offset,vec", [
    (16, 4, 4, 0, True),      # the main path's shape class
    (16, 4, 4, 4, True),      # a view 16 bytes in is still aligned
    (16, 0, 8, 0, True),      # one-sided halo
    (18, 4, 4, 0, False),     # n not a multiple of 4
    (16, 3, 4, 0, False),     # nl not a multiple of 4
    (16, 4, 2, 0, False),     # nr not a multiple of 4
    (16, 4, 4, 1, False),     # a source at an odd float offset
])
def test_vector_path_rule(n, nl, nr, offset, vec):
    buf = torch.zeros(4 * n + 8)    # CPU allocations are 64-byte aligned
    srcs = [buf[i * n: (i + 1) * n] for i in range(3)]
    srcs.append(buf[3 * n + offset: 4 * n + offset])
    assert vector_path(srcs, n, nl, nr) is vec
    # the wrapper's windows do not depend on the path
    got = remote_halo_window(srcs, nl, nr)
    assert torch.equal(got, remote_halo_window_plain(srcs, nl, nr))


def test_wrapper_refusals():
    srcs = [torch.zeros(8), torch.zeros(8)]
    with pytest.raises(ValueError):
        remote_halo_window([torch.zeros(8, dtype=torch.float64)] * 2, 2, 2)
    with pytest.raises(ValueError):
        remote_halo_window([torch.zeros(8), torch.zeros(6)], 2, 2)
    with pytest.raises(ValueError):
        remote_halo_window(srcs, 9, 0)
    with pytest.raises(ValueError):
        remote_halo_window(srcs, 0, -1)
    with pytest.raises(ValueError):
        remote_halo_window([torch.zeros(16)[::2]] * 2, 2, 2)
    with pytest.raises(ValueError):
        remote_halo_window([torch.zeros(8)] * 65, 1, 1)
    with pytest.raises(NotImplementedError):
        remote_halo_window([torch.zeros(8), torch.zeros(8, device="meta")],
                           2, 2)
    a = port.poisson3d_7pt(4)
    with pytest.raises(ValueError, match="remote"):
        SlabDia(data=(torch.zeros(7, 64),), offsets=a.offsets, dims=a.dims,
                transport="pallas")
    with pytest.raises(ValueError, match="remote"):
        port.AMGSolver(a, port.AMGParams(), grid=(4, 4, 4),
                       mesh=port.ShardMesh(2, "cpu"), device="cpu",
                       transport="pallas")
