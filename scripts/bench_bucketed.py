"""GPU shape-bucketed size-drag benchmark.

Drags a SpecificSize node 1000→1400 px (the canvas-size interaction,
`/root/reference/src/node/mod.rs:33-47`) through an image→mix→h2n→blur
chain and reports, per size: host marshal time (index/weight arguments),
end-to-end evaluation wall time, and the cumulative compile count. The
point being demonstrated: compiles == buckets crossed (3 at 1000→1400 with
256-px buckets), not sizes visited (17) — where each compile costs
seconds, that is the difference between an interactive drag and a frozen
UI.

Run on the GPU: python scripts/bench_bucketed.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

from kanter_core_tpu import (
    MixType, Node, NodeGraph, NodeType, ResizePolicy, Size, SlotId,
)
from kanter_core_tpu.bucketed import BucketedGraph


def build():
    g = NodeGraph()
    img = g.add_node(Node(NodeType.Image("/root/reference/data/heart_256.png")))
    sep = g.add_node(Node(NodeType.SeparateRgba()))
    g.connect(img, sep, SlotId(0), SlotId(0))
    val = g.add_node(Node(NodeType.Value(0.7)))
    mix = Node(NodeType.Mix(MixType.MULTIPLY))
    mix.resize_policy = ResizePolicy.SpecificSize(Size(1000, 1000))
    mix = g.add_node(mix)
    g.connect(sep, mix, SlotId(0), SlotId(0))
    g.connect(val, mix, SlotId(0), SlotId(1))
    h2n = g.add_node(Node(NodeType.HeightToNormal()))
    g.connect(mix, h2n, SlotId(0), SlotId(0))
    bl = g.add_node(Node(NodeType.Blur(1.3)))
    g.connect(h2n, bl, SlotId(0), SlotId(0))
    out = g.add_node(Node(NodeType.OutputRgba("out")))
    g.connect(bl, out, SlotId(0), SlotId(0))
    return g, mix, out


def main() -> None:
    print(f"backend: {jax.default_backend()}")
    g, mix, out = build()
    bg = BucketedGraph(g, targets=[(out, SlotId(0))])
    sizes = list(range(1000, 1401, 25))
    total = 0.0
    for s in sizes:
        bg.set_size(mix, Size(s, s))
        t0 = time.perf_counter()
        planes = bg()[(out, SlotId(0))]
        dt = time.perf_counter() - t0
        total += dt
        print(
            f"size {s:4d}: {dt*1e3:8.1f} ms  traces={bg.traces}  "
            f"out={planes[0].shape}"
        )
    print(
        f"\n{len(sizes)} sizes, {bg.traces} compiles, "
        f"total {total:.1f} s (amortized {total/len(sizes)*1e3:.0f} ms/size)"
    )


if __name__ == "__main__":
    main()
