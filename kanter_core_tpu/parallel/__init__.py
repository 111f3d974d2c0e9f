"""Multi-device scale-out: batch data-parallel and spatially-sharded graph
evaluation over a `jax.sharding.Mesh`.

The reference is single-host task-parallel only (SURVEY §2); here scale-out
is expressed with GSPMD: shard the batch axis of many canvases (DP) and/or
the row axis of one huge canvas (spatial TP) with `NamedSharding`, jit the
fused graph program, and let XLA insert the collectives (the
HeightToNormal wrap stencil's `jnp.roll` becomes a collective-permute halo
exchange automatically).
"""

from .session import BatchedLiveSession
from .sharded import (
    BatchedGraph,
    make_mesh,
    shard_planes_batch,
    shard_planes_rows,
)

__all__ = [
    "BatchedGraph",
    "BatchedLiveSession",
    "make_mesh",
    "shard_planes_batch",
    "shard_planes_rows",
]
