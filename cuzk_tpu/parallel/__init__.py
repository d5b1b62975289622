"""Multi-device / multi-host parallelism for cuzk_tpu.

The reference is single-process single-GPU (SURVEY.md §2.2); this subsystem
is the scaling dimension BASELINE.json's north star asks for: batches and tree leaves sharded over a ``jax.sharding.Mesh``, with
XLA collectives (all_gather) collapsing the shrinking upper Merkle levels.
"""

from cuzk_tpu.parallel.distributed import (
    make_mesh,
    shard_batch,
    sharded_hash_pairs,
    sharded_hash_single,
    sharded_merkle_root,
    sharded_build_levels,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "sharded_hash_pairs",
    "sharded_hash_single",
    "sharded_merkle_root",
    "sharded_build_levels",
]
