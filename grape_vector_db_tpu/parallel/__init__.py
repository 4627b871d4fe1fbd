"""Mesh-parallel corpus sharding (the data plane of cluster mode).

Replaces the reference's scatter-gather shard search (shard.rs:759-901, which
was mock/HTTP) with SPMD over a ``jax.sharding.Mesh``: the corpus shards across
the ``shard`` mesh axis, every device computes its local top-k, and one
``all_gather`` over the device interconnect merges the per-shard winners.
"""

from grape_vector_db_tpu.parallel.mesh import (
    ShardedFlatIndex,
    ShardedInt4IvfIndex,
    ShardedInt8IvfIndex,
    ShardedIvfIndex,
    make_mesh,
    make_mesh_2d,
    replicated_sharded_topk,
    sharded_ivf_topk,
    sharded_scored_topk,
)

__all__ = ["ShardedFlatIndex", "ShardedIvfIndex", "ShardedInt8IvfIndex",
           "ShardedInt4IvfIndex", "make_mesh", "make_mesh_2d",
           "replicated_sharded_topk", "sharded_ivf_topk", "sharded_scored_topk"]
