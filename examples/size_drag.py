"""Interactive canvas-size drag via shape-bucketed evaluation.

Dragging a canvas size changes plane shapes, and XLA compiles per shape —
so a naive slider drag recompiles on every pixel tick. The bucketed
evaluator (`kanter_core_tpu.bucketed`) pads planes to size buckets and
moves all size-dependent data movement into program arguments: within a
bucket every size reuses one executable, and output pixels stay
bit-identical to the unbucketed compiler.

Runs on CPU in a few seconds; through the live engine the same behavior is
one knob: `TextureProcessor(bucket_sizes=True)`.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


from kanter_core_tpu import (
    MixType, Node, NodeGraph, NodeType, ResizePolicy, Size, SlotId,
)
from kanter_core_tpu.bucketed import BucketedGraph

REFERENCE_DATA = "/root/reference/data"


def main() -> None:
    graph = NodeGraph()
    img = graph.add_node(Node(NodeType.Image(f"{REFERENCE_DATA}/heart_128.png")))
    sep = graph.add_node(Node(NodeType.SeparateRgba()))
    graph.connect(img, sep, SlotId(0), SlotId(0))
    val = graph.add_node(Node(NodeType.Value(0.8)))
    mix = Node(NodeType.Mix(MixType.MULTIPLY))
    mix.resize_policy = ResizePolicy.SpecificSize(Size(300, 300))
    mix = graph.add_node(mix)
    graph.connect(sep, mix, SlotId(0), SlotId(0))
    graph.connect(val, mix, SlotId(0), SlotId(1))
    h2n = graph.add_node(Node(NodeType.HeightToNormal()))
    graph.connect(mix, h2n, SlotId(0), SlotId(0))
    out = graph.add_node(Node(NodeType.OutputRgba("out")))
    graph.connect(h2n, out, SlotId(0), SlotId(0))

    bucketed = BucketedGraph(graph, targets=[(out, SlotId(0))])

    print("dragging the canvas 300 → 440 px in 10-px ticks:")
    for size in range(300, 441, 10):
        bucketed.set_size(mix, Size(size, size))
        t0 = time.perf_counter()
        planes = bucketed()[(out, SlotId(0))]
        ms = (time.perf_counter() - t0) * 1e3
        print(
            f"  {size:3d} px: {ms:7.1f} ms   compiles so far: {bucketed.traces}"
            f"   out {planes[0].shape}"
        )
    print(
        f"\n{bucketed.traces} compiles for 15 sizes — one per size bucket "
        "(pow-2 ladder below 256 px), not one per pixel size."
    )


def main_segmented() -> None:
    """Act 2 — the same drag on a graph containing a Distance node.

    Distance's jump flood cannot run on a padded plane, so it is not
    bucketable; through the LIVE engine (`bucket_sizes=True`) the fused
    partition SPLITS at the Distance boundary: the bucketable majority
    rides cached bucketed evaluators (one compile per bucket) and only
    the small Distance segment dense-compiles per size — instead of
    recompiling the whole pipeline per size."""
    import numpy as np

    from kanter_core_tpu import TextureProcessor

    with TextureProcessor(100_000_000, bucket_sizes=True) as tp:
        lg = tp.new_live_graph()
        with lg.write() as g:
            pat = g.add_node(Node(NodeType.Pattern(
                128, 128, "Brick", cells_x=3, cells_y=5,
                mortar=0.15, bevel=0.06, seed=1,
            )))
            mix = g.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
            val = g.add_node(Node(NodeType.Value(0.8)))
            g.connect(pat, mix, SlotId(0), SlotId(0))
            g.connect(val, mix, SlotId(0), SlotId(1))
            g.node_mut(mix).resize_policy = ResizePolicy.SpecificSize(
                Size(120, 120)
            )
            dst = g.add_node(Node(NodeType.Distance(12.0)))
            g.connect(mix, dst, SlotId(0), SlotId(0))
            dmix = g.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
            g.connect(mix, dmix, SlotId(0), SlotId(0))
            g.connect(dst, dmix, SlotId(0), SlotId(1))
            out = g.add_node(Node(NodeType.OutputGray("out")))
            g.connect(dmix, out, SlotId(0), SlotId(0))

        print("\nact 2 — dragging a Distance-containing graph 100 → 124 px:")
        for size in range(100, 125, 6):
            with lg.write() as g:
                g.node_mut(mix).resize_policy = ResizePolicy.SpecificSize(
                    Size(size, size)
                )
            t0 = time.perf_counter()
            px = TextureProcessor.buffer_rgba(lg, out, SlotId(0))
            ms = (time.perf_counter() - t0) * 1e3
            print(f"  {size:3d} px: {ms:7.1f} ms   out {np.shape(px)}")
        eng = tp.engine
        traces = sum(ev.traces for ev in eng._bucketed_programs.values())
        print(
            f"segment evaluators: {len(eng._bucketed_programs)} "
            f"({traces} traces), dense programs: {len(eng._fused_programs)} "
            "(the Distance segment only — the bucketable majority never "
            "dense-recompiled)"
        )


if __name__ == "__main__":
    main()
    main_segmented()
