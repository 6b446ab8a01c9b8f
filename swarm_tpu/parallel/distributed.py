"""Multi-host execution (jax.distributed) for the d=1 network build.

The single-host sharded engines (parallel/mesh.py) are mesh-shape
agnostic: the range-partitioned sort-join only uses collectives
(all_to_all / psum) over the "amps" axis. This module wires the same
programs across processes:

 - `maybe_initialize()` joins the coordination service when the
   SWARM_TPU_COORDINATOR / SWARM_TPU_NUM_PROCESSES /
   SWARM_TPU_PROCESS_ID environment variables are set (the standard
   jax.distributed contract: coordinator address, process count and
   process id are given explicitly);
 - `global_mesh()` spans every process's devices (NVLink within a
   host, the network across hosts — the collectives ride whatever the
   topology provides);
 - `DistributedJoin` shards the hash/key arrays over the global mesh
   with each process feeding its local shard
   (host_local_array_to_global_array), runs the same sharded join
   body, and gathers the verified edge list to every host with a
   process_allgather, after which each host holds the full d=1
   network and host 0 runs BFS + writers (SURVEY.md sect. 5.8 contract).

Capability parity anchor: the reference's pthread pool scales one
host (src/utils/threads.h); this layer is the cross-host replacement.
"""

import os

import numpy as np


def env_config():
    """(coordinator, num_processes, process_id) from the environment,
    or None when unset (single-process mode)."""
    coord = os.environ.get("SWARM_TPU_COORDINATOR")
    if not coord:
        return None
    return (
        coord,
        int(os.environ.get("SWARM_TPU_NUM_PROCESSES", "1")),
        int(os.environ.get("SWARM_TPU_PROCESS_ID", "0")),
    )


def maybe_initialize() -> int:
    """Join the jax.distributed coordination service if configured.
    Returns this host's process index (0 when single-process)."""
    cfg = env_config()
    if cfg is None:
        return 0
    import jax

    coord, nproc, pid = cfg
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=nproc, process_id=pid
    )
    return pid


def is_primary() -> bool:
    """True on the host that owns I/O (process 0)."""
    cfg = env_config()
    return cfg is None or cfg[2] == 0


def global_mesh():
    """A 1-D mesh over every device of every process (power-of-two
    prefix, matching the single-host engines' requirement)."""
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    d_pow2 = 1 << (len(devices).bit_length() - 1)
    return Mesh(np.array(devices[:d_pow2]), ("amps",))


class DistributedJoin:
    """Range-partitioned d=1 sort-join across a multi-process mesh.

    Every process must call build_network() with the SAME database
    (the fasta is read on each host — shared-filesystem contract, like
    the reference's input handling); array placement is process-local,
    compute is SPMD, and the edge list is allgathered so each host
    returns identical pairs.
    """

    def __init__(self, db, mesh=None):
        from .mesh import SortJoinShardedEngine

        self.mesh = mesh if mesh is not None else global_mesh()
        self._engine = SortJoinShardedEngine(db, mesh=self.mesh)

    def build_network(self, no_break: bool, abundances: np.ndarray):
        return self._engine.build_network(no_break, abundances)
