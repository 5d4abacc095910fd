"""Distributed (z-slab sharded) structured AMG-PCG (counterpart of
``omp_amg_tpu/parallel/``, its structured subset).

A :class:`~.mesh.ShardMesh` of ``d`` shards stands where the reference has a
1D ``jax`` mesh over axis "rows". Every shard lives on the mesh's one device;
shard-local work runs shard by shard, and a ``psum`` is a sum over the shards
in shard order.
"""
