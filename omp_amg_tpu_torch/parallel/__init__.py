"""Distributed AMG-PCG (counterpart of ``omp_amg_tpu/parallel/``): the
z-slab structured family and the row-sharded PMIS family.

A :class:`~.mesh.ShardMesh` of ``d`` shards stands where the reference has a
1D ``jax`` mesh over axis "rows": every shard lives on the mesh's one
device, shard-local work runs shard by shard, and a ``psum`` is a sum over
the shards in shard order. Built by :func:`.multihost.global_mesh`, the
mesh spreads the shards over processes, each holding its own; its
collectives gather every rank's partials and run the same
shard-order sum. :mod:`.scaling_model` is the reference's weak-scaling
model on the port's operators.
"""
