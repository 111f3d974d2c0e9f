"""Interactive editing loop: build a graph, render, edit, re-render.

Demonstrates the core LiveGraph workflow a `vismut_core` user knows
(request → await_clean_read → buffer_rgba), plus what changed: the dirty
partition is re-evaluated as ONE fused XLA program, and `changed_consume`
feeds a UI diff. Runs on the CPU backend so it works anywhere:

    python examples/interactive_editing.py
"""

import tempfile
import time

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


from kanter_core_tpu import (  # noqa: E402
    MixType,
    Node,
    NodeType,
    SlotId,
    TextureProcessor,
)


def make_input_png(size: int = 256) -> str:
    """A procedural radial gradient so the example is self-contained."""
    import numpy as np

    from kanter_core_tpu import Size
    from kanter_core_tpu.ops.image_io import save_rgba_png

    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    r = np.hypot(x - 0.5, y - 0.5) * 2.0
    gray = np.clip(1.0 - r, 0.0, 1.0)
    u8 = (gray * 255).astype(np.uint8)
    rgba = np.stack([u8, u8, u8, np.full_like(u8, 255)], axis=-1).reshape(-1)
    path = os.path.join(tempfile.mkdtemp(prefix="kanter_example_"), "input.png")
    save_rgba_png(path, rgba, Size(size, size))
    return path


def main():
    tp = TextureProcessor(memory_threshold=1 << 30)
    lg = tp.new_live_graph()
    input_png = make_input_png()

    with lg.write() as g:
        noise = g.add_node(Node(NodeType.Image(input_png)))
        sep = g.add_node(Node(NodeType.SeparateRgba()))
        gain = g.add_node(Node(NodeType.Value(1.0)))
        mix = g.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
        out = g.add_node(Node(NodeType.OutputGray("out")))
        g.connect(noise, sep, SlotId(0), SlotId(0))
        g.connect(sep, mix, SlotId(0), SlotId(0))   # red channel on the left
        g.connect(gain, mix, SlotId(0), SlotId(1))
        g.connect(mix, out, SlotId(0), SlotId(0))

    # first render: decodes the image, compiles the fused program
    t0 = time.perf_counter()
    pixels = TextureProcessor.buffer_rgba(lg, out, SlotId(0))
    print(f"first render: {len(pixels)} bytes in {time.perf_counter() - t0:.3f}s "
          "(includes XLA compile)")

    # interactive edits: only the Value binding changes → the cached fused
    # program re-runs without retracing
    for gain_value in (0.75, 0.5, 0.25):
        t0 = time.perf_counter()
        with lg.write() as g:
            g.node_mut(gain).node_type = NodeType.Value(gain_value)
        pixels = TextureProcessor.buffer_rgba(lg, out, SlotId(0))
        dirty_nodes = sorted(int(n) for n in lg.changed_consume())
        print(f"gain={gain_value}: re-render {time.perf_counter() - t0:.3f}s "
              f"center={pixels[(128 * 256 + 128) * 4]} changed={dirty_nodes}")

    # undo/redo: each edit above is one history unit; undo restores the
    # previous parameters and re-renders bit-exactly from the cached program
    import numpy as np

    t0 = time.perf_counter()
    lg.undo()  # back to gain=0.5
    undone = TextureProcessor.buffer_rgba(lg, out, SlotId(0))
    print(f"undo → gain=0.5 again in {time.perf_counter() - t0:.3f}s "
          f"(undo_depth={lg.undo_depth()}, redo_depth={lg.redo_depth()})")
    lg.redo()  # forward to gain=0.25
    redone = TextureProcessor.buffer_rgba(lg, out, SlotId(0))
    print(f"redo bit-exact vs last edit: {np.array_equal(redone, pixels)}")

    tp.shutdown_now()


if __name__ == "__main__":
    main()
