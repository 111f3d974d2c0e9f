"""GPU measurement of a size drag on a Distance-containing graph.

Drags a SpecificSize payload through K sizes inside one bucket on the
GPU, through the live engine, twice: bucket_sizes=True (the r5
segmented route — bucketed segments reuse one executable per bucket, the
Distance segment dense-compiles per size) vs the plain dense processor
(recompiles the WHOLE pipeline per size). Reports per-tick walls. The
expected shape: the segmented route pays the Distance-segment compile
per new size but NOT the full-pipeline compile; within-bucket repeat
sizes are compile-free in the segmented route.

Run: python scripts/exp_drag_chip.py   (on the GPU)
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

CANVAS = int(os.environ.get("EXP_DRAG_CANVAS", "1024"))


def _build(g, w, h):
    from kanter_core_tpu import (
        MixType, Node, NodeType, ResizePolicy, Size, SlotId,
    )

    pat = g.add_node(Node(NodeType.Pattern(
        CANVAS, CANVAS, "Brick", cells_x=4, cells_y=8,
        mortar=0.12, bevel=0.06, seed=3,
    )))
    mix = g.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
    val = g.add_node(Node(NodeType.Value(0.8)))
    g.connect(pat, mix, SlotId(0), SlotId(0))
    g.connect(val, mix, SlotId(0), SlotId(1))
    g.node_mut(mix).resize_policy = ResizePolicy.SpecificSize(Size(w, h))
    dst = g.add_node(Node(NodeType.Distance(64.0)))
    g.connect(mix, dst, SlotId(0), SlotId(0))
    dmix = g.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
    g.connect(mix, dmix, SlotId(0), SlotId(0))
    g.connect(dst, dmix, SlotId(0), SlotId(1))
    # the flagship's tail: the segmented route's value is the DELTA
    # between the whole-pipeline compile and the Distance-segment compile,
    # so the bucketable majority must carry flagship-scale compile weight
    # (a first cut with only a 6-node graph measured 0.8x — the JFA was
    # the whole compile either way)
    curv = g.add_node(Node(NodeType.Curvature(5.0)))
    g.connect(dmix, curv, SlotId(0), SlotId(0))
    cmix = g.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
    g.connect(dmix, cmix, SlotId(0), SlotId(0))
    g.connect(curv, cmix, SlotId(0), SlotId(1))
    ao = g.add_node(Node(NodeType.AmbientOcclusion(2.0, 1.0)))
    g.connect(cmix, ao, SlotId(0), SlotId(0))
    amix = g.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
    g.connect(cmix, amix, SlotId(0), SlotId(0))
    g.connect(ao, amix, SlotId(0), SlotId(1))
    h2n = g.add_node(Node(NodeType.HeightToNormal()))
    g.connect(amix, h2n, SlotId(0), SlotId(0))
    blur = g.add_node(Node(NodeType.Blur(1.2)))
    g.connect(h2n, blur, SlotId(0), SlotId(0))
    hsv = g.add_node(Node(NodeType.Hsv(25.0, 1.1, 0.95)))
    g.connect(blur, hsv, SlotId(0), SlotId(0))
    warp = g.add_node(Node(NodeType.Warp(37.0, 5.0)))
    g.connect(hsv, warp, SlotId(0), SlotId(0))
    g.connect(pat, warp, SlotId(0), SlotId(1))
    out = g.add_node(Node(NodeType.OutputRgba("out")))
    g.connect(warp, out, SlotId(0), SlotId(0))
    return mix, out


def drag(bucket_sizes: bool, sizes) -> dict:
    from kanter_core_tpu import (
        ResizePolicy, Size, SlotId, TextureProcessor,
    )

    tp = TextureProcessor(4_000_000_000, bucket_sizes=bucket_sizes)
    try:
        lg = tp.new_live_graph()
        with lg.write() as g:
            mix, out = _build(g, *sizes[0])
        t0 = time.perf_counter()
        first_px = TextureProcessor.buffer_rgba(lg, out, SlotId(0))
        first_s = time.perf_counter() - t0
        walls, checks = [], [int(np.asarray(first_px, np.uint64).sum() % (1 << 32))]
        for w, h in sizes[1:]:
            with lg.write() as g:
                g.node_mut(mix).resize_policy = ResizePolicy.SpecificSize(
                    Size(w, h)
                )
            t0 = time.perf_counter()
            px = TextureProcessor.buffer_rgba(lg, out, SlotId(0))
            walls.append(round(time.perf_counter() - t0, 3))
            checks.append(int(np.asarray(px, np.uint64).sum() % (1 << 32)))
        eng = tp.engine
        return {
            "first_render_s": round(first_s, 3),
            "tick_walls_s": walls,
            "median_tick_s": round(float(np.median(walls)), 3),
            "checksums": checks,
            "checksums_distinct": len(set(checks)) == len(checks),
            "dense_programs": len(eng._fused_programs),
            "bucketed_evaluators": len(eng._bucketed_programs),
            "bucketed_traces": sum(
                ev.traces for ev in eng._bucketed_programs.values()
            ),
        }
    finally:
        tp.shutdown_now()


def main() -> None:
    import jax

    # all inside the 1024-bucket (1020..1024 pad to 1024), distinct sizes
    sizes = [(1024, 1024), (1020, 1016), (1012, 1024), (1008, 1000),
             (1024, 1012), (1016, 1020)]
    seg = drag(True, sizes)
    dense = drag(False, sizes)
    assert seg["checksums"] == dense["checksums"], "segmented != dense pixels"
    print(json.dumps({
        "exp": "distance_drag_chip",
        "backend": jax.default_backend(),
        "canvas": CANVAS,
        "n_sizes": len(sizes),
        "segmented": seg,
        "dense": dense,
        "speedup_median_tick": round(
            dense["median_tick_s"] / seg["median_tick_s"], 2
        ),
    }))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
    os._exit(0)
