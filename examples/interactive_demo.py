"""Interactive editing demo: build a texture pipeline, read it, edit it,
watch only the dirty partition re-evaluate (one fused XLA program), and
inspect the engine's metrics.

Run:  python examples/interactive_demo.py [image.png]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time


import numpy as np

from kanter_core_tpu import (  # noqa: E402
    LiveGraph,
    MixType,
    Node,
    NodeType,
    SlotId,
    TextureProcessor,
)
from kanter_core_tpu.graphs import invert_graph
from kanter_core_tpu.ops.image_io import save_rgba_png
from kanter_core_tpu.slot_data import Size

IMAGE = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/data/image_2.png"


def main():
    tp = TextureProcessor(memory_threshold=512 * 1024 * 1024)
    lg = tp.new_live_graph()

    with lg.write() as g:
        g.use_cache = True
        image = g.add_node(Node(NodeType.Image(IMAGE)))
        sep = g.add_node(Node(NodeType.SeparateRgba()))
        inv = g.add_node(Node(NodeType.Graph(invert_graph())))
        gain = g.add_node(Node(NodeType.Value(1.0)))
        mix = g.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
        h2n = g.add_node(Node(NodeType.HeightToNormal()))
        out = g.add_node(Node(NodeType.OutputRgba("out")))
        g.connect(image, sep, SlotId(0), SlotId(0))
        g.connect(sep, inv, SlotId(0), invert_graph().input_slot_id_with_name("in"))
        g.connect(inv, mix, invert_graph().output_slot_id_with_name("out"), SlotId(0))
        g.connect(gain, mix, SlotId(0), SlotId(1))
        g.connect(mix, h2n, SlotId(0), SlotId(0))
        g.connect(h2n, out, SlotId(0), SlotId(0))

    t0 = time.perf_counter()
    pixels = TextureProcessor.buffer_rgba(lg, out, SlotId(0))
    print(f"cold eval: {(time.perf_counter()-t0)*1e3:.1f} ms, {pixels.size//4} px")

    # slider drag: each edit re-runs ONE cached fused program
    for value in (0.8, 0.6, 0.4, 0.2):
        with lg.write() as g:
            g.node_mut(gain).node_type = NodeType.Value(value)
        t0 = time.perf_counter()
        pixels = TextureProcessor.buffer_rgba(lg, out, SlotId(0))
        print(f"gain={value}: re-eval {(time.perf_counter()-t0)*1e3:.2f} ms")

    with lg.read() as g:
        size = g.slot_data_size(out, SlotId(0))
    save_rgba_png("/tmp/demo_normal_map.png", pixels, size)
    print("wrote /tmp/demo_normal_map.png")

    metrics = tp.metrics()
    print("device bytes:", metrics["bytes_device"], "| host bytes:", metrics["bytes_host"])
    print("fused programs:", metrics["fused_programs"])
    for kind, stats in metrics["timeline"]["per_kind_ms"].items():
        print(f"  {kind:16s} n={stats['count']:3d} mean={stats['mean']:.2f} ms")
    tp.shutdown_now()


if __name__ == "__main__":
    main()
