"""Fully-procedural material: NO input images — noise → levels →
gradient-map albedo, plus height-to-normal and blurred-AO maps, all from
one seamlessly-tiling FBM noise source, in one fused dirty-tracked graph.

Demonstrates the parameter-as-argument design end to end: cycling the
noise seed, dragging the contrast (Levels), recoloring the ramp
(GradientMap), and grading the result (Hsv) each re-render through a
cached program — the program
fingerprint normalizes every edited field out. Note the granularity:
the FIRST edit of a given dirty-shape compiles that partition once
(a clean upstream node becomes a partition INPUT instead of being
recomputed), and a GradientMap edit that changes the stop COUNT
reshapes the trace; every subsequent drag of the same shape is
argument-only and reuses the executable, so each edit below is timed
on its second application.

Run:  python examples/procedural_material.py [out_dir] [size]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time


import numpy as np  # noqa: E402

from kanter_core_tpu import (  # noqa: E402
    MixType,
    Node,
    NodeType,
    SlotId,
    TextureProcessor,
)
from kanter_core_tpu.geometry import Size  # noqa: E402
from kanter_core_tpu.ops.image_io import save_rgba_png  # noqa: E402

OUT_DIR = sys.argv[1] if len(sys.argv) > 1 else "/tmp/kanter_procedural"
SIZE = int(sys.argv[2]) if len(sys.argv) > 2 else 512

ROCK_RAMP = [
    (0.00, 0.13, 0.09, 0.08, 1.0),  # dark crevice
    (0.45, 0.46, 0.38, 0.31, 1.0),  # mid rock
    (0.75, 0.70, 0.64, 0.55, 1.0),  # lit face
    (1.00, 0.93, 0.91, 0.85, 1.0),  # highlight
]
MOSS_RAMP = [
    (0.00, 0.05, 0.10, 0.04, 1.0),
    (0.50, 0.18, 0.35, 0.12, 1.0),
    (1.00, 0.55, 0.70, 0.35, 1.0),
]


def main():
    os.makedirs(OUT_DIR, exist_ok=True)
    tp = TextureProcessor(memory_threshold=512 * 1024 * 1024)
    lg = tp.new_live_graph()
    with lg.write() as g:
        g.use_cache = True
        # height field: tiling FBM noise, contrast-shaped by Levels
        noise = g.add_node(Node(NodeType.Noise(SIZE, SIZE, 6, 5, seed=1, persistence=0.55)))
        contrast = g.add_node(Node(NodeType.Levels(0.25, 0.75, 1.4, 0.0, 1.0)))
        g.connect(noise, contrast, SlotId(0), SlotId(0))
        # albedo: colorize the shaped height through a gradient ramp
        albedo = g.add_node(Node(NodeType.GradientMap(ROCK_RAMP)))
        g.connect(contrast, albedo, SlotId(0), SlotId(0))
        # normal map from the same height field
        normal = g.add_node(Node(NodeType.HeightToNormal()))
        g.connect(contrast, normal, SlotId(0), SlotId(0))
        # cheap AO: blurred height, inverted (Mix SUBTRACT from a white Value)
        blur = g.add_node(Node(NodeType.Blur(4.0)))
        g.connect(contrast, blur, SlotId(0), SlotId(0))
        white = g.add_node(Node(NodeType.Value(1.0)))
        ao = g.add_node(Node(NodeType.Mix(MixType.SUBTRACT)))
        g.connect(white, ao, SlotId(0), SlotId(0))
        g.connect(blur, ao, SlotId(0), SlotId(1))
        # surface detail: a second noise field directionally warps the
        # albedo (crevice colors smear along one slope direction)
        detail = g.add_node(Node(NodeType.Noise(SIZE, SIZE, 9, 3, seed=7, persistence=0.5)))
        warp = g.add_node(Node(NodeType.Warp(120.0, max(2.0, SIZE / 64.0))))
        g.connect(albedo, warp, SlotId(0), SlotId(0))
        g.connect(detail, warp, SlotId(0), SlotId(1))
        # final grade: an Hsv adjust over the warped albedo (hue/sat/value
        # are one program argument — grading drags reuse the executable)
        grade = g.add_node(Node(NodeType.Hsv(0.0, 1.0, 1.0)))
        g.connect(warp, grade, SlotId(0), SlotId(0))
        outs = {}
        for name, src in (("albedo", grade), ("normal", normal), ("ao", ao)):
            out = g.add_node(Node(NodeType.OutputRgba(name)))
            g.connect(src, out, SlotId(0), SlotId(0))
            outs[name] = out

    t0 = time.perf_counter()
    for name, node in outs.items():
        px = TextureProcessor.buffer_rgba(lg, node, SlotId(0))
        save_rgba_png(os.path.join(OUT_DIR, f"{name}.png"), px, Size(SIZE, SIZE))
    print(f"first render (compile + eval): {time.perf_counter() - t0:.2f}s → {OUT_DIR}")

    # each pair: a WARM edit (first of its dirty-shape — may compile that
    # partition once) then the measured DRAG (argument-only, cached program)
    MOSS_DRAG = [(p, r * 1.1, g_, b, a) for (p, r, g_, b, a) in MOSS_RAMP]
    edits = [
        ("seed cycle",
         lambda g: g.set_noise(noise, SIZE, SIZE, 6, 5, 2, 0.55),
         lambda g: g.set_noise(noise, SIZE, SIZE, 6, 5, 3, 0.55)),
        ("contrast drag",
         lambda g: g.set_levels(contrast, 0.15, 0.85, 1.1, 0.0, 1.0),
         lambda g: g.set_levels(contrast, 0.20, 0.80, 1.2, 0.0, 1.0)),
        ("moss recolor",
         lambda g: g.set_gradient_map(albedo, MOSS_RAMP),
         lambda g: g.set_gradient_map(albedo, MOSS_DRAG)),
        ("warp drag",
         lambda g: g.set_warp(warp, 120.0, 3.0),
         lambda g: g.set_warp(warp, 135.0, 5.5)),
        ("hsv grade",
         lambda g: g.set_hsv(grade, 25.0, 1.15, 1.0),
         lambda g: g.set_hsv(grade, 40.0, 1.3, 0.95)),
    ]
    for label, warm, drag in edits:
        with lg.write() as g:
            warm(g)
        t0 = time.perf_counter()
        TextureProcessor.buffer_rgba(lg, outs["albedo"], SlotId(0))
        warm_ms = (time.perf_counter() - t0) * 1000
        with lg.write() as g:
            drag(g)
        t0 = time.perf_counter()
        px = TextureProcessor.buffer_rgba(lg, outs["albedo"], SlotId(0))
        dt = (time.perf_counter() - t0) * 1000
        save_rgba_png(
            os.path.join(OUT_DIR, f"albedo_{label.split()[0]}.png"),
            px,
            Size(SIZE, SIZE),
        )
        print(f"{label}: first-of-shape {warm_ms:.1f} ms, "
              f"drag {dt:.1f} ms (cached program, argument-only)")

    tp.shutdown_now()


if __name__ == "__main__":
    main()
