"""Capacity demo: evaluate a graph whose dense working set EXCEEDS device
memory, through the real engine, via blockwise tiled evaluation.

The reference can only spill whole *finished* planes to disk
(`/root/reference/src/transient_buffer.rs:388-406`) — a working set larger
than memory cannot evaluate at all. Here `TextureProcessor(tile_bytes=…)`
drops the fused partition into row-band evaluation (`kanter_core_tpu.tiled`)
so only band-sized slices ever touch the device.

Default config: a 48-mix-node logistic-map chain over a canvas sized from
the device's `memory_stats()["bytes_limit"]` so the dense footprint (≈ 57
node outputs × canvas² × 4 B) is twice the device's memory; the chain is
seeded by a 128² procedural noise plane, upscaled, so leaf uploads stay
tiny. Verification: the run is repeated with a different band size; results
must be bit-identical (band-size invariance is the tiled path's correctness
property, `tests/test_tiled.py`).

Usage:
    python scripts/demo_beyond_hbm.py [--canvas N] [--depth 48]
        [--dense]   # also attempt the dense path to demonstrate the OOM
"""

import argparse
import os
import sys
import time
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from kanter_core_tpu.graphs import add_logistic_step
from kanter_core_tpu import (
    MixType,
    Node,
    NodeGraph,
    NodeId,
    NodeType,
    ResizePolicy,
    Size,
    SlotId,
    TextureProcessor,
)

def build(canvas: int, depth: int):
    """128² noise seed → upscale to `canvas` → logistic-map mix chain
    (graphs.bounded_chain_graph's step, which XLA cannot collapse) → gray out."""
    graph = NodeGraph()
    seed = graph.add_node(Node(NodeType.Noise(128, 128, 4, 3, 7, 0.5)))
    one = graph.add_node(Node(NodeType.Value(1.0)))
    v_val = graph.add_node(Node(NodeType.Value(0.96)))

    def upscale() -> NodeId:
        up = Node(NodeType.Mix(MixType.ADD))  # x + 0, resized
        up.resize_policy = ResizePolicy.SpecificSize(Size(canvas, canvas))
        up = graph.add_node(up)
        graph.connect(seed, up, SlotId(0), SlotId(0))
        return up

    chain = upscale()
    steps = max(1, depth // 5)
    for _ in range(steps):
        chain = add_logistic_step(graph, chain, one, v_val)
    out = graph.add_node(Node(NodeType.OutputGray("out")))
    graph.connect(chain, out, SlotId(0), SlotId(0))
    return graph, out


def run_tiled(canvas: int, depth: int, tile_bytes: int):
    with TextureProcessor(1 << 62, tile_bytes=tile_bytes) as tp:
        lg = tp.new_live_graph()
        graph, out = build(canvas, depth)
        with lg.write() as g:
            g.set_node_graph(graph)
            g.prioritise(out)
        t0 = time.perf_counter()
        # wait for the tiled evaluation; read the host-tier planes directly
        # (no device round trip for verification)
        from kanter_core_tpu.live_graph import LiveGraph

        with LiveGraph.await_clean_write(lg, out) as g:
            plane = g.slot_data(out, SlotId(0)).image.planes[0].host_data()
        wall = time.perf_counter() - t0
        crc = zlib.crc32(np.ascontiguousarray(plane).tobytes())
        assert len(tp.engine._fused_programs) == 0, "dense path ran!"
        return wall, crc, plane.shape


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--canvas", type=int, default=None,
                    help="default: twice the device's memory, dense")
    ap.add_argument("--depth", type=int, default=48)
    ap.add_argument("--dense", action="store_true", help="also attempt dense (expect OOM)")
    args = ap.parse_args()

    import jax

    node_outputs = 5 + max(1, args.depth // 5) * 5 + 2  # rough count
    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
    if args.canvas is None:
        if not limit:
            raise SystemExit(f"{jax.devices()[0]} reports no memory limit; pass --canvas")
        args.canvas = int((2 * limit / (node_outputs * 4)) ** 0.5) // 1024 * 1024
    dense_gb = node_outputs * args.canvas * args.canvas * 4 / 1e9
    print(f"device: {jax.devices()[0].device_kind}, bytes_limit {limit}")
    print(
        f"graph: {args.canvas}^2 canvas, ~{node_outputs} node outputs, "
        f"dense working set ~{dense_gb:.0f} GB"
    )

    if args.dense:
        try:
            from kanter_core_tpu.compiler import CompiledGraph

            graph, out = build(args.canvas, args.depth)
            prog = CompiledGraph(graph, targets=[(out, SlotId(0))])
            jax.block_until_ready(prog()[(out, SlotId(0))])
            print("dense: unexpectedly succeeded")
        except Exception as e:  # noqa: BLE001
            print(f"dense: failed as expected — {type(e).__name__}: {str(e)[:160]}")

    # two different budgets → different band sizes → bit-identical results
    # is the self-check (band-size invariance, tests/test_tiled.py)
    crcs = []
    for frac in (16, 32):
        budget = max(1, int(dense_gb * 1e9 / frac))
        wall, crc, shape = run_tiled(args.canvas, args.depth, budget)
        crcs.append(crc)
        print(
            f"tiled (budget {budget/1e9:.2f} GB = footprint/{frac}): OK {shape} "
            f"in {wall:.1f}s, crc32 {crc:#010x}",
            flush=True,
        )
    assert crcs[0] == crcs[1], "band-size invariance violated"
    print("band-size invariance: OK (crcs identical)")


if __name__ == "__main__":
    main()
