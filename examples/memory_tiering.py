"""Memory tiering: watch planes spill device → host → disk under a budget.

Sets a deliberately tiny memory threshold so the buffer queue's manager
thread evicts least-recently-used planes, then reads one back (fault-in
re-promotes it). Mirrors the reference's `TransientBufferQueue` behavior
(`transient_buffer.rs:351-406`) with one more tier:

    python examples/memory_tiering.py
"""

import time

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


from kanter_core_tpu import (  # noqa: E402
    MixType,
    Node,
    NodeType,
    ResizePolicy,
    Size,
    SlotId,
    TextureProcessor,
)

from examples.interactive_editing import make_input_png  # noqa: E402


def main():
    size = 512
    plane_bytes = size * size * 4
    # budget: ~3 planes on device, ~2 on host, rest spills to disk
    tp = TextureProcessor(
        memory_threshold=3 * plane_bytes, host_memory_threshold=2 * plane_bytes
    )

    lg = tp.new_live_graph()
    input_png = make_input_png()
    with lg.write() as g:
        g.use_cache = True  # keep every intermediate alive so tiers fill up
        img = Node(NodeType.Image(input_png))
        img.resize_policy = ResizePolicy.SpecificSize(Size(size, size))
        prev = g.add_node(img)
        outs = []
        for i in range(8):
            v = g.add_node(Node(NodeType.Value(0.9)))
            m = g.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
            g.connect(prev, m, SlotId(0), SlotId(0))
            g.connect(v, m, SlotId(0), SlotId(1))
            prev = m
            outs.append(m)
        out = g.add_node(Node(NodeType.OutputRgba("out")))
        g.connect(prev, out, SlotId(0), SlotId(0))

    TextureProcessor.buffer_rgba(lg, out, SlotId(0))

    deadline = time.time() + 5.0
    while time.time() < deadline:
        m = tp.metrics()
        if m["bytes_storage"] > 0:
            break
        time.sleep(0.05)
    m = tp.metrics()
    print(f"device={m['bytes_device']/1e6:.1f}MB host={m['bytes_host']/1e6:.1f}MB "
          f"disk={m['bytes_storage']/1e6:.1f}MB")

    with lg.read() as g:
        mid = outs[0]
        print("mid node in_memory before touch:", g.slot_in_memory(mid, SlotId(0)))

    # u8 export reads spilled planes HOST-side (the measured-fastest path)
    # without promoting them to the device tier:
    pixels = TextureProcessor.buffer_rgba(lg, mid, SlotId(0))
    with lg.read() as g:
        print(f"u8 export returned {len(pixels)} bytes without device "
              f"promotion; in_memory: {g.slot_in_memory(mid, SlotId(0))}")

    # DEVICE fault-in happens when compute touches the plane. Lift the
    # budget first (thresholds are live-mutable, like the reference's
    # tests) — otherwise the over-subscribed LRU would evict the freshly
    # faulted plane again within a millisecond.
    tp.memory_threshold.store(16 * plane_bytes)
    with lg.read() as g:
        for plane in g.slot_data(mid, SlotId(0)).image.planes:
            plane.data()  # device handles (in_memory needs EVERY plane)
    time.sleep(0.1)  # let the manager thread settle
    with lg.read() as g:
        print("after a compute-path touch, in_memory:",
              g.slot_in_memory(mid, SlotId(0)))

    tp.shutdown_now()


if __name__ == "__main__":
    main()
