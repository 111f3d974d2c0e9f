"""Batched, sharded evaluation: one graph over N canvases on a device mesh.

The reference is single-host task-parallel; here the same graph evaluates a
whole batch of canvases data-parallel over a `jax.sharding.Mesh` (GSPMD
inserts the collectives). On the GPU the mesh spans the cards; on the CPU
(`JAX_PLATFORMS=cpu`) it spans 8 virtual devices:

    python examples/batch_sharded.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")


import numpy as np  # noqa: E402

from kanter_core_tpu import Node, NodeGraph, NodeType, SlotId  # noqa: E402
from kanter_core_tpu.parallel import BatchedLiveSession, make_mesh  # noqa: E402


def main():
    g = NodeGraph()
    inp = g.add_node(Node(NodeType.InputGray("height")))
    h2n = g.add_node(Node(NodeType.HeightToNormal()))
    out = g.add_node(Node(NodeType.OutputRgba("normal")))
    g.connect(inp, h2n, SlotId(0), SlotId(0))
    g.connect(h2n, out, SlotId(0), SlotId(0))

    mesh = make_mesh()
    session = BatchedLiveSession(g, batch_input_ids=[inp], mesh=mesh)

    batch, size = 8, 256
    rng = np.random.default_rng(0)
    heights = rng.random((batch, size, size), dtype=np.float32)
    session.set_input(inp, heights)

    result = session.render()
    (key, planes), = result.items()
    print(f"rendered batch: target={key} planes={len(planes)} "
          f"shape={planes[0].shape} sharding={planes[0].sharding}")

    # edit one input canvas → the cached vmapped program re-runs, no retrace
    heights[0] *= 0.5
    session.set_input(inp, heights)
    result = session.render()
    print("after edit:", float(np.asarray(result[key][0][0]).mean()))


if __name__ == "__main__":
    main()
