"""Multi-device scaling for the port.

The JAX package shards the row axis across a ``jax.sharding.Mesh`` ("chunk
parallel"), optionally shards the query batch, and merges per-shard exact
top-k results with k-sized all-gathers. The port keeps that design on a
``[rows, batch]`` grid of torch devices (:class:`~.mesh.Mesh`): one tensor
per row shard on its device, every shard's program run on its device, and
the k-sized partials merged on the lead device. A mesh may span processes
(``init_distributed``, JAX's ``jax.distributed.initialize``): each process
then holds and runs the entries it owns, and a query's partials meet in
one gloo ``all_gather`` of a host buffer (``exchange.py``), merged alike
on every process's local lead.
"""

from .dist_query import ShardedVecStore, sharded_topk
from .mesh import Mesh, init_distributed, make_mesh, process_count, process_index
from .meta_sharded import (
    ShardedMetaStore,
    build_sharded,
    materialize_f32_slabs_sharded,
    materialize_int8_slabs_sharded,
    sharded_geometry,
)
from .shards import ShardedTensor

__all__ = [
    "ShardedVecStore",
    "sharded_topk",
    "init_distributed",
    "make_mesh",
    "process_count",
    "process_index",
    "Mesh",
    "ShardedMetaStore",
    "ShardedTensor",
    "build_sharded",
    "materialize_f32_slabs_sharded",
    "materialize_int8_slabs_sharded",
    "sharded_geometry",
]
