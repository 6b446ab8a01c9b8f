"""Multi-chip parallelism: device meshes + sharded clustering kernels.

The reference's only parallelism is a pthread pool over shared memory
(src/utils/threads.h, SURVEY.md section 2 "parallelism strategies").
The device equivalent is SPMD over a jax.sharding.Mesh: amplicon
batches are sharded across devices (data parallel), the
sequence-hash table and Zobrist tables are replicated, and candidate
counts are merged with psum. Cross-host meshes (jax.distributed) are
wired in .distributed.

Submodules are imported lazily: jax.distributed.initialize() must run
before anything touches the XLA backend, so importing this package
must stay side-effect free.
"""


def __getattr__(name):
    if name in ("ShardedNeighborEngine", "SortJoinShardedEngine", "make_mesh"):
        from . import mesh

        return getattr(mesh, name)
    if name in ("mesh", "distributed"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
