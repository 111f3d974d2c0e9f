"""Material generation demo: one heightmap in, four PBR texture maps out.

Builds `models.pbr_material_graph` (normal / AO / roughness / albedo as one
dirty-tracked graph), feeds it a heightmap decoded from an image, renders
all four maps through the engine (one fused program), edits the AO blur
width, and shows that only the AO/roughness branch re-evaluates.

Run:  python examples/material_maps.py [height.png] [out_dir]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time


import numpy as np

from kanter_core_tpu import (  # noqa: E402
    Node,
    NodeType,
    NodeTypeKind,
    SlotData,
    SlotId,
    SlotImage,
    TextureProcessor,
)
from kanter_core_tpu.models import pbr_material_graph
from kanter_core_tpu.ops.image_io import read_slot_image, save_rgba_png
from kanter_core_tpu.slot_data import Size

IMAGE = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/data/clouds.png"
OUT_DIR = sys.argv[2] if len(sys.argv) > 2 else "/tmp/kanter_material"


def main():
    os.makedirs(OUT_DIR, exist_ok=True)
    height = read_slot_image(IMAGE).planes[0].host_data()  # channel R as height
    print(f"height map: {IMAGE} {height.shape}")

    tp = TextureProcessor(memory_threshold=512 * 1024 * 1024)
    lg = tp.new_live_graph()
    with lg.write() as g:
        g.use_cache = True
        g.set_node_graph(pbr_material_graph(ao_sigma=6.0))
        (inp,) = [
            n.node_id
            for n in g.node_graph.nodes
            if n.node_type.kind == NodeTypeKind.INPUT_GRAY
        ]
        g.add_input_slot_data(SlotData(inp, SlotId(0), SlotImage.Gray(height)))
        outputs = {
            g.node_graph.node(oid).node_type.payload: oid
            for oid in g.node_graph.output_ids()
        }

    t0 = time.perf_counter()
    for name, oid in outputs.items():
        pixels = TextureProcessor.buffer_rgba(lg, oid, SlotId(0))
        path = os.path.join(OUT_DIR, f"{name}.png")
        save_rgba_png(path, np.asarray(pixels), Size(height.shape[1], height.shape[0]))
        print(f"  wrote {path}")
    print(f"full material: {time.perf_counter() - t0:.2f}s (first compile included)")

    # edit the AO blur width: only the AO/roughness branch goes dirty
    with lg.write() as g:
        (ao_blur,) = [
            n.node_id
            for n in g.node_graph.nodes
            if n.node_type.kind == NodeTypeKind.BLUR
            and float(n.node_type.payload) == 6.0
        ]
        g.set_blur_sigma(ao_blur, 9.0)
        dirty = [oid for _name, oid in outputs.items() if g.node_state(oid).value != "Clean"]
        print(f"after sigma edit, dirty outputs: "
              f"{[g.node_graph.node(o).node_type.payload for o in dirty]}")

    t0 = time.perf_counter()
    for name, oid in outputs.items():
        TextureProcessor.buffer_rgba(lg, oid, SlotId(0))
    print(f"incremental re-eval: {time.perf_counter() - t0:.2f}s")
    print("metrics:", {k: v for k, v in tp.metrics().items() if k != "timeline"})
    tp.shutdown_now()


if __name__ == "__main__":
    main()
