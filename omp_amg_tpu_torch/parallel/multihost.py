"""Multi-process entry: counterpart of ``omp_amg_tpu/parallel/multihost.py``.

Every process runs the SAME program. :func:`maybe_initialize` wires the
processes into one ``torch.distributed`` group (the gloo backend, over TCP),
and :func:`global_mesh` returns a :class:`~.mesh.ShardMesh` over all of
them: rank r owns shards ``[r·local, (r+1)·local)``. The per-shard setups
(:mod:`.dist_pmis_setup`, :mod:`.dist_setup`) run on every rank; the host
PMIS setup is deterministic by global row ids, so every rank builds the
same hierarchy and places its own shards, and the sharded solve's counts
and x are bitwise those of a one-process ``ShardMesh`` of the same shard
count.

Gloo is the one backend: it runs on the CPU and between processes that
share one card. NCCL refuses two ranks on one device.

Environment gate (set by the launcher for every process):

- ``OMP_AMG_COORDINATOR``  "host:port" of rank 0's rendezvous (required)
- ``OMP_AMG_NUM_PROCS``    total process count (required)
- ``OMP_AMG_PROC_ID``      this process's rank (required)

Or ``OMP_AMG_DIST=1`` with torch's own ``env://`` variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), as a cluster
launcher such as ``torchrun`` sets them.

Two processes on one card (gloo, CPU tensors on the wire)::

    OMP_AMG_COORDINATOR=127.0.0.1:29511 OMP_AMG_NUM_PROCS=2 \\
        OMP_AMG_PROC_ID=0 python3 my_solve.py &
    OMP_AMG_COORDINATOR=127.0.0.1:29511 OMP_AMG_NUM_PROCS=2 \\
        OMP_AMG_PROC_ID=1 python3 my_solve.py
"""

from __future__ import annotations

import atexit
import os


def maybe_initialize(env=None) -> bool:
    """Initialise the process group when env-gated.

    Returns True when ``torch.distributed.init_process_group`` was called
    (or the group was already initialised), False when the gate is absent:
    a single-process run is not affected. A group it initialises is
    destroyed at exit: left to the interpreter's teardown, gloo's threads
    can abort the process after its work is done.
    """
    import torch.distributed as dist

    env = os.environ if env is None else env
    coord = env.get("OMP_AMG_COORDINATOR")
    auto = env.get("OMP_AMG_DIST") == "1"
    if not coord and not auto:
        return False
    if dist.is_initialized():
        return True  # already initialised (idempotent entry)
    if coord:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coord}",
            world_size=int(env["OMP_AMG_NUM_PROCS"]),
            rank=int(env["OMP_AMG_PROC_ID"]))
    else:
        dist.init_process_group("gloo", init_method="env://")
    atexit.register(_destroy)
    return True


def _destroy() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(local_shards: int = 1, device="cuda"):
    """A :class:`~.mesh.ShardMesh` of ``world_size × local_shards`` shards
    over the initialised group, rank r holding shards ``[r·local_shards,
    (r+1)·local_shards)``. Across processes the rank's device is
    ``cuda:{rank % torch.cuda.device_count()}`` for ``device="cuda"`` (so
    two ranks on one card both take ``cuda:0``), else ``device`` itself
    (``"cpu"`` for a CPU run)."""
    import torch.distributed as dist

    from .mesh import ShardMesh

    if not dist.is_initialized():
        raise RuntimeError("a mesh over processes needs torch.distributed "
                           "initialised (maybe_initialize)")
    if int(local_shards) < 1:
        raise ValueError(f"a rank needs at least one shard, got "
                         f"{local_shards}")
    world = dist.get_world_size()
    return ShardMesh(world * int(local_shards), device, world=world,
                     rank=dist.get_rank())
