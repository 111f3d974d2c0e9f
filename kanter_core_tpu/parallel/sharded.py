"""Sharded / batched fused-graph evaluation."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..compiler import CompiledGraph
from ..node_graph import NodeGraph

BATCH_AXIS = "batch"
ROW_AXIS = "rows"


def make_mesh(n_devices: Optional[int] = None, axes=(BATCH_AXIS,), shape=None):
    """A 1-D (or reshaped) device mesh over the first `n_devices` devices."""
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    devices = np.asarray(devices)
    if shape is not None:
        devices = devices.reshape(shape)
    elif len(axes) == 1:
        devices = devices.reshape((len(devices),))
    return Mesh(devices, axes)


def shard_planes_batch(mesh, stacked):
    """Place `[B, H, W]` stacked planes with the batch axis sharded."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(stacked, NamedSharding(mesh, P(BATCH_AXIS, None, None)))


def shard_planes_rows(mesh, plane):
    """Place one `[H, W]` plane with rows sharded across devices (spatial TP)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(plane, NamedSharding(mesh, P(ROW_AXIS, None)))


class BatchedGraph:
    """vmap of a fused graph program over a batch of canvases, jitted over a
    mesh — the DP path for "16×4k canvases" style workloads.

    `batch_keys` names the program arguments that carry a leading batch axis
    (e.g. `image_<id>` plane tuples); everything else (Value scalars, …) is
    broadcast.

    `dtype="bfloat16"` stores leaves/outputs at bf16 (DESIGN.md §9) — a
    footprint feature; its batched throughput on the GPU is not measured
    yet (XLA's fusion cost model may split big fusions at the upcasts).
    """

    def __init__(
        self,
        node_graph: NodeGraph,
        batch_keys: set[str],
        targets=None,
        include_u8: bool = False,
        mesh=None,
        dtype=None,
    ):
        import jax

        # a mesh with a spatial "rows" axis keeps the Pallas blur viable:
        # the shard_map'd kernel (ring halo exchange) shards over that axis
        # and composes with the batch vmap (vmap-of-shard_map is supported
        # and bit-identical). A batch-only mesh disables Pallas (an
        # unsharded Pallas custom call is not GSPMD-partitionable).
        spatial_axis = (
            ROW_AXIS if (mesh is not None and ROW_AXIS in mesh.axis_names) else None
        )
        base = CompiledGraph(
            node_graph, targets, include_u8,
            pallas_ok=mesh is None or spatial_axis is not None,
            mesh=mesh if spatial_axis is not None else None,
            mesh_axis=spatial_axis,
            dtype=dtype,
        )
        self.base = base
        self.batch_keys = set(batch_keys)
        self.mesh = mesh

        def fn(args):
            return base._raw_fn(args)

        def make_axes(args):
            return {
                key: jax.tree.map(lambda _: 0, value)
                if key in self.batch_keys
                else jax.tree.map(lambda _: None, value)
                for key, value in args.items()
            }

        self._make_axes = make_axes
        self._fn = fn
        # keyed by the call's arg STRUCTURE (key set + per-key pytree
        # treedef): in_axes is a pytree mirroring the args dict, so a later
        # call that binds an ADDITIONAL key — or rebinds an existing key
        # with a different plane-count tuple (gray→rgba rebind) — must get
        # fresh axes; caching on the first call's jit unconditionally (or on
        # key names alone) would raise a pytree-structure mismatch on every
        # call thereafter (and a failed first trace would poison the cache)
        self._jitted: dict = {}

    def __call__(self, **overrides):
        import jax

        args = dict(self.base._bindings)
        args.update(overrides)
        key = tuple(
            (k, jax.tree.structure(args[k])) for k in sorted(args)
        )
        jitted = self._jitted.get(key)
        if jitted is None:
            axes = self._make_axes(args)
            jitted = jax.jit(jax.vmap(self._fn, in_axes=(axes,)))
            self._jitted[key] = jitted
        return jitted(args)

    def shard_batch_arg(self, stacked_planes):
        """Shard a `[B, ...]` argument over the mesh batch axis."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        if self.mesh is None:
            return stacked_planes
        spec = P(BATCH_AXIS, *([None] * (np.ndim(stacked_planes) - 1)))
        return jax.device_put(stacked_planes, NamedSharding(self.mesh, spec))
